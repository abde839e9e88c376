"""A ("data", "grid") mesh of ranks and its collectives.

The port's counterpart of `neural_rx_tpu/dist/mesh.py`. The mesh has two
axes, laid out as JAX's `reshape(data, grid)` of the ranks (rank r sits at
data row r // grid, grid column r % grid):

- "data": the batch (Monte-Carlo or training) axis. A grid column's ranks
  form its data group: error counters and gradients are summed over it.
- "grid": the resource grid's subcarrier axis. A data row's ranks form its
  grid group: the CGNN's 3x3 convolutions exchange halos with their ring
  neighbours in it (`dist/fused_sharded.py`), the input power norm sums
  over it, and the LLRs are gathered over it before decoding.

Where JAX annotates a sharding and lets XLA move the data, the port slices
(`constrain` cuts a global tensor down to this rank's block) and calls the
collectives here. Every rank creates every group, in the same order.

backend: "nccl" when every rank has a card of its own (the tensors stay on
the card); "gloo" for CPU tests and for several ranks that share one card
(NCCL refuses two ranks on one GPU). Under gloo a CUDA tensor is staged
through host memory by the functions below, in the open; nothing switches
transport or device after a failure. A single process outside a
`torch.distributed` group gets a 1 x 1 mesh with no group, whose
collectives are identities.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a data x grid mesh of ranks 0..data*grid-1."""
    data: int
    grid: int
    rank: int
    backend: str | None  # None: one process, no group
    data_group: object = None  # this rank's grid column
    grid_group: object = None  # this rank's data row

    @property
    def shape(self) -> dict:
        return {"data": self.data, "grid": self.grid}

    @property
    def data_index(self) -> int:
        return self.rank // self.grid

    @property
    def grid_index(self) -> int:
        return self.rank % self.grid

    @property
    def grid_ranks(self) -> list[int]:
        """Global ranks of this rank's grid group, in grid order."""
        row = self.data_index * self.grid
        return list(range(row, row + self.grid))


def factor(n: int) -> tuple[int, int]:
    """JAX's default factorisation of n devices: 2 ways on data when n is
    even and above 1, the rest on grid."""
    data = 2 if n % 2 == 0 and n > 1 else 1
    return data, n // data


def make_mesh(n: int | None = None, data: int | None = None,
              grid: int | None = None, backend: str | None = None) -> Mesh:
    """The ("data", "grid") mesh of the n ranks of the process group
    (default: all of them; n must be the world size). Without data and
    grid, `factor(n)`. backend: of the mesh's groups (default: the process
    group's). Outside a process group only n = 1 exists: a mesh without
    groups. Every rank must call this with the same arguments."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    n = world if n is None else n
    if n != world:
        raise ValueError(f"a mesh spans every rank: n = {n}, world {world}")
    if data is None or grid is None:
        data, grid = factor(n)
    if data * grid != n:
        raise ValueError(f"data {data} x grid {grid} != {n} ranks")
    if not initialized:
        return Mesh(data, grid, 0, None)
    backend = backend or dist.get_backend()
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    rank = dist.get_rank()
    data_groups = [dist.new_group([d * grid + g for d in range(data)],
                                  backend=backend) for g in range(grid)]
    grid_groups = [dist.new_group([d * grid + g for g in range(grid)],
                                  backend=backend) for d in range(data)]
    return Mesh(data, grid, rank, backend, data_groups[rank % grid],
                grid_groups[rank // grid])


def _block(size: int, parts: int, index: int, what: str) -> slice:
    if size % parts:
        raise ValueError(f"{what} of {size} does not split into {parts} "
                         f"equal blocks")
    step = size // parts
    return slice(index * step, (index + 1) * step)


def batch_grid_sharding(mesh: Mesh, shape, batch_axis: int | None = 0,
                        sc_axis: int | None = None) -> tuple:
    """The index of this rank's block of a global tensor of `shape`: the
    batch axis split over "data", the subcarrier axis over "grid"."""
    index = [slice(None)] * len(shape)
    if batch_axis is not None:
        index[batch_axis] = _block(shape[batch_axis], mesh.data,
                                   mesh.data_index, "a batch")
    if sc_axis is not None:
        ax = sc_axis % len(shape)
        index[ax] = _block(shape[ax], mesh.grid, mesh.grid_index,
                           "a subcarrier axis")
    return tuple(index)


def constrain(x: torch.Tensor, mesh: Mesh | None, batch_axis: int | None = 0,
              sc_axis: int | None = None) -> torch.Tensor:
    """This rank's block of the global tensor x (x itself for mesh None)."""
    if mesh is None:
        return x
    return x[batch_grid_sharding(mesh, x.shape, batch_axis, sc_axis)]


def staged(x: torch.Tensor, backend: str) -> torch.Tensor:
    """The tensor a collective of `backend` takes for x: under gloo a host
    copy of a CUDA tensor, else x."""
    if backend == "gloo" and x.device.type == "cuda":
        return x.cpu()
    return x


def all_reduce(x: torch.Tensor, group, backend: str | None) -> torch.Tensor:
    """The sum of x over `group` (None: every rank), as a new tensor on
    x's device (x itself for backend None: no group)."""
    if backend is None:
        return x
    buf = staged(x, backend)
    buf = buf.clone() if buf is x else buf
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group, backend: str | None, size: int,
               dim: int) -> torch.Tensor:
    """The `size` ranks' x of `group` concatenated along dim, in group
    order (x itself without a group)."""
    if backend is None:
        return x
    buf = staged(x.contiguous(), backend)
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def sum_over_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over this rank's data group."""
    return all_reduce(x, mesh.data_group, mesh.backend)


def sum_over_grid(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x summed over this rank's grid group."""
    return all_reduce(x, mesh.grid_group, mesh.backend)


def gather_grid(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The grid group's subcarrier blocks of x joined along dim."""
    return all_gather(x, mesh.grid_group, mesh.backend, mesh.grid, dim)
