"""Several processes: initialisation, the global mesh, per-rank generators.

The port's counterpart of `neural_rx_tpu/dist/multihost.py`. A process is
a rank of a `torch.distributed` group: `initialize` joins it (nothing for a
single process), `global_mesh` lays every rank out on a ("data", "grid")
mesh as JAX lays its global devices out (the grid axis inside a host, the
hosts stacked along data), and `host_generator` gives each rank its own
reproducible random stream, the counterpart of `host_fold_key`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(backend: str, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None):
    """Join the process group (`torch.distributed.init_process_group` with
    these arguments); nothing for a single process (world_size None or 1).
    backend: "nccl" when every rank has a card of its own, "gloo" on the
    CPU or for ranks that share one card. init_method: e.g.
    "tcp://localhost:PORT" or "file:///path"."""
    if world_size is None or world_size <= 1:
        return
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def world() -> tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(grid_per_host: int | None = None,
                backend: str | None = None) -> Mesh:
    """The ("data", "grid") mesh over every rank. The grid axis (halo
    exchanges) spans grid_per_host consecutive ranks (default: the cards of
    this host, at least 1); the rest stack along data."""
    _, n = world()
    if grid_per_host is None:
        grid_per_host = max(min(torch.cuda.device_count(), n), 1)
    if n % grid_per_host:
        raise ValueError(f"{n} ranks do not split into grids of "
                         f"{grid_per_host}")
    return make_mesh(n, data=n // grid_per_host, grid=grid_per_host,
                     backend=backend)


def host_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s stream: a function of (seed, rank) alone,
    different for every rank."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def host_generator(seed: int, device="cpu", rank: int | None = None
                   ) -> torch.Generator:
    """A `torch.Generator` on `device` seeded from (seed, rank) (default:
    this process's rank): streams differ across ranks and repeat per
    rank."""
    if rank is None:
        rank = world()[0]
    return torch.Generator(device=device).manual_seed(host_seed(seed, rank))
