"""Profiling helpers: profiler traces, latency percentiles, chained device
time.

The port's counterpart of `neural_rx_tpu/utils/profiling.py`.
`profile_trace` writes a `torch.profiler` Chrome trace of a block;
`time_fn` measures the p50/p99/mean latency of a synchronised call;
`chained_device_time_ms` measures the serialized device time of one call,
the analog of trtexec's "GPU compute time". On a CUDA device the times
come from CUDA events and `torch.cuda.synchronize`; on CPU tensors from
the host clock (which is then the CPU's time, not a device's).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from .debug import named_leaves


def _leaves(out) -> list:
    return [x for _, x in named_leaves(out)]


@contextlib.contextmanager
def profile_trace(log_dir: str = "profile-trace"):
    """Profile the block (host and, with a GPU, device activity) and write
    its Chrome trace to log_dir/trace.json; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def force_sync(out):
    """Wait for `out`: the devices of its CUDA tensors synchronised (CPU
    tensors are done when returned). Returns out."""
    for dev in {x.device for x in _leaves(out) if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return out


def tunnel_rtt_ms(iters: int = 30, device="cuda") -> float:
    """Median ms of the smallest round trip to `device`: one elementwise
    launch on a scalar and its copy to the host."""
    x = torch.ones((), device=device)
    float(x + 1.0)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        float(x + 1.0)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def time_fn(fn, *args, iters: int = 50, warmup: int = 3) -> dict:
    """p50/p99/mean host latency in ms of fn(*args), each call waited for
    (`force_sync`): the host's launch and the device's run together; for
    the device time alone use `chained_device_time_ms`."""
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    force_sync(out)
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        force_sync(fn(*args))
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "mean_ms": float(lat_ms.mean())}


def chained_device_time_ms(fn, y0: torch.Tensor, *, length: int = 100,
                           reps: int = 10) -> float:
    """Serialized time of one call of fn(y) in ms.

    A chain of n calls feeds call i+1 y + 1e-6 * (the sum over every
    output leaf of its float32 mean), so no call can overlap or be left
    out, and nothing reaches the host inside a chain. Returns (T(length) -
    T(1)) / (length - 1) with T the median over reps of a chain's time: by
    CUDA events on the device for a CUDA y0, else by the host clock."""
    if length < 2:
        raise ValueError("length must be at least 2")

    def chain(n):
        y = y0
        for _ in range(n):
            out = fn(y)
            acc = sum(leaf.float().mean() for leaf in _leaves(out))
            y = y + 1e-6 * acc
        return y

    cuda = y0.device.type == "cuda"

    def med(n):
        ts = []
        for _ in range(reps):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(n)
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                chain(n)
                ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    force_sync(chain(1))  # warm-up
    return (med(length) - med(1)) / (length - 1)
