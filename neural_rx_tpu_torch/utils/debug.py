"""Numerical debugging: NaN guards and an anomaly-detecting, eager context.

The port's counterpart of `neural_rx_tpu/utils/debug.py`. `nan_guard`
checks every floating output leaf of a call for NaN and Inf;
`debug_context` turns on autograd's anomaly detection (the first backward
op that makes a NaN raises, with the forward op's traceback) and, with
eager=True, makes the deploy engine's CUDA-graph calls
(`deploy/aot.py:CapturedCall`) run their function eagerly, so a debugger
or a print sees every op. Neither swaps a kernel for its plain version.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_EAGER = contextvars.ContextVar("nrx_eager", default=False)


def eager() -> bool:
    """True inside `debug_context(eager=True)`."""
    return _EAGER.get()


def named_leaves(out, name: str = "out"):
    """(path, tensor) of every tensor in a tree of dicts, lists and
    tuples, e.g. ("out[1]['llr']", t)."""
    if isinstance(out, torch.Tensor):
        yield name, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from named_leaves(v, f"{name}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from named_leaves(v, f"{name}[{i}]")


def nan_guard(fn):
    """fn wrapped: after each call every floating-point tensor in its
    output is checked, and a NaN or Inf raises ValueError naming the leaf
    (e.g. "out[1]", "out['llr']")."""
    def guarded(*args, **kwargs):
        out = fn(*args, **kwargs)
        for name, leaf in named_leaves(out):
            if leaf.is_floating_point() or leaf.is_complex():
                if not bool(torch.isfinite(leaf).all()):
                    raise ValueError(f"non-finite value in output leaf "
                                     f"{name}")
        return out
    return guarded


@contextlib.contextmanager
def debug_context(nans: bool = True, eager: bool = False):
    """Autograd anomaly detection set to `nans` and, with eager, CUDA-graph
    calls run eagerly, inside the block; the previous settings come back on
    exit."""
    prev = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(nans)
    token = _EAGER.set(bool(eager) or _EAGER.get())
    try:
        yield
    finally:
        _EAGER.reset(token)
        torch.autograd.set_detect_anomaly(prev)
