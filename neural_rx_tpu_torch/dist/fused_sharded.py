"""The fused stack (K1) and CGNN iteration (K3) on subcarrier shards.

The port's counterpart of `neural_rx_tpu/dist/fused_sharded.py`. A 3x3
separable stack of L layers reads L columns beyond each edge of its
output, so a shard of the subcarrier axis runs it exactly once it holds
`halo = L` columns of each ring neighbour, exchanged once per stack:

1. each rank sends its `halo` edge columns to both neighbours of its grid
   group (`batch_isend_irecv`); the ring is not cyclic, so the band-edge
   shards receive zeros, the "SAME" zero padding of an unsharded run;
2. the kernel runs on the extended [W_local + 2 halo] shard with the valid
   range (lo, hi) that keeps a band edge's missing neighbour zero before
   every layer (the kernels' pad-to-bucket masking);
3. the halo columns are cropped; the core is exact.

The iteration (K3) exchanges the state's halo (the update stack's L
columns of d_s channels) and the positional encoding's before each call;
its aggregation MLP, user sum and readouts are per resource element and
need nothing from the neighbours. On a CPU tensor the wrappers run the
kernels' plain versions, as the kernels' own wrappers do.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.cgnn_iter import fused_iteration
from ..kernels.sepconv import fused_conv_stack
from .mesh import Mesh, staged


def exchange_halo(x: torch.Tensor, mesh: Mesh, halo: int, dim: int):
    """(from_left, from_right): the `halo` edge columns (along dim) of this
    rank's left and right neighbours in its grid group, zeros where the
    band ends."""
    w = x.shape[dim]
    if w < halo:
        raise ValueError(f"a shard of {w} columns is narrower than the "
                         f"stack's halo of {halo}")
    g, n = mesh.grid_index, mesh.grid
    from_left = x.new_zeros(x.narrow(dim, 0, halo).shape)
    from_right = torch.zeros_like(from_left)
    if n == 1:
        return from_left, from_right
    ranks = mesh.grid_ranks
    bufs, ops = [], []
    for peer, edge, recv in ((g - 1, x.narrow(dim, 0, halo), from_left),
                             (g + 1, x.narrow(dim, w - halo, halo),
                              from_right)):
        if not 0 <= peer < n:
            continue
        send = staged(edge.contiguous(), mesh.backend)
        into = staged(recv, mesh.backend)
        ops += [dist.P2POp(dist.isend, send, ranks[peer], mesh.grid_group),
                dist.P2POp(dist.irecv, into, ranks[peer], mesh.grid_group)]
        bufs.append((into, recv))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for into, recv in bufs:
        if into is not recv:
            recv.copy_(into)
    return from_left, from_right


def halo_extend(x: torch.Tensor, mesh: Mesh, halo: int, dim: int):
    """(x_ext, (lo, hi)): x with its neighbours' halos on both sides along
    dim, and the valid column range of x_ext (the band's columns)."""
    w = x.shape[dim]
    from_left, from_right = exchange_halo(x, mesh, halo, dim)
    x_ext = torch.cat([from_left, x, from_right], dim=dim).contiguous()
    lo = halo if mesh.grid_index == 0 else 0
    hi = halo + w if mesh.grid_index == mesh.grid - 1 else w + 2 * halo
    return x_ext, (lo, hi)


def stack_halo(p) -> int:
    """The halo of a separable stack: one column per layer."""
    return len(p["hidden"]) + 1


def sharded_stack(stack, p, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """stack(p, x_ext, sc_valid) on this rank's subcarrier shard x [N, H,
    W_local, C] (W on the mesh's grid axis), cropped back to W_local."""
    halo = stack_halo(p)
    x_ext, valid = halo_extend(x, mesh, halo, dim=2)
    return stack(p, x_ext, valid)[:, :, halo:halo + x.shape[2]]


def fused_conv_stack_sharded(p, x: torch.Tensor, mesh: Mesh
                             ) -> torch.Tensor:
    """Drop-in for `kernels.sepconv.fused_conv_stack` on the local shard x
    [N, H, W_local, C_in], the subcarrier axis W sharded over the mesh's
    grid axis: the stack's output on this shard [N, H, W_local, C_out],
    through the stack kernel (its plain version on a CPU tensor)."""
    return sharded_stack(
        lambda p, x, v: fused_conv_stack(p, x, sc_valid=v), p, x, mesh)


def fused_iteration_sharded(it_params, s: torch.Tensor, pe: torch.Tensor,
                            active_tx: torch.Tensor, mesh: Mesh,
                            readout_p=None, chest_p=None,
                            iterate=fused_iteration):
    """Drop-in for `kernels.cgnn_iter.fused_iteration` on the local shards
    s [b, T, H, W_local, d_s] and pe [T, H, W_local, d_pe]: the halos of s
    and pe exchanged, `iterate` (the iteration kernel, or its plain
    version) on the extended shard with its valid range, then cropped.
    Returns what `iterate` returns, on this shard's columns."""
    halo = stack_halo(it_params["update"])
    w = s.shape[3]
    s_ext, valid = halo_extend(s, mesh, halo, dim=3)
    pe_ext, _ = halo_extend(pe, mesh, halo, dim=2)
    out = iterate(it_params, s_ext, pe_ext, active_tx, valid, readout_p,
                  chest_p)
    if isinstance(out, tuple):
        return tuple(o[:, :, :, halo:halo + w] for o in out)
    return out[:, :, :, halo:halo + w]
