"""One engine per PRB bucket, pad-to-bucket dispatch, a CUDA graph per
(bucket, valid width), engine files and latency measurement.

The port's counterpart of `neural_rx_tpu/deploy/aot.py`. The JAX package
compiles one AOT executable per PRB bucket (the reference's TensorRT
min/opt/max profiles); here each bucket has an `AerialNRX` engine, and in
graph mode each (bucket, valid width) it serves is captured once into a
CUDA graph: the kernels take the valid range as launch arguments
(`kernels/sepconv.py`, `kernels/cgnn_iter.py`), so a graph fixes it, as the
JAX executable's run-time `num_valid_sc` does. A request at a non-bucket
PRB count is served by the smallest bucket that fits: the slot is
zero-padded on the subcarrier axis, the pilot estimates are scattered into
the bucket's pilot order, the engine runs with num_valid_sc = 12 n_prb,
and the outputs are cropped back; the padding, scatter and crop are part
of the captured graph.

The JAX package's `serialize_engine` / `load_engine` (a StableHLO artifact
that runs without the model-construction code) become `save_engine` /
`load_engine`: a `torch.save` file of the parameters, the static tables,
the CGNN configuration, the MCS, the iteration count, the dtype and the
bucket. Its `serialize_compiled` / `load_compiled` (a compiled executable)
have no artifact here: a CUDA graph cannot be saved, and what they save at
load time (compilation) the engine file plus the kernel library already
built in `_build/` save too.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from .. import weights
from ..rx.cgnn import CGNNConfig
from ..utils import debug
from .aerial import TABLE_NAMES, AerialNRX

DEFAULT_PRB_BUCKETS = (4, 16, 32, 64, 132, 273)
ENGINE_FORMAT = "nrx_rt-aerial-engine-1"


class CapturedCall:
    """fn(*inputs) captured in a CUDA graph on static copies of the example
    inputs, after one eager warm-up (which uploads the static tables,
    builds the kernel library and caches the launch set-up outside the
    capture). A call copies its inputs in and replays; it returns the
    graph's own output tensors, which the next call overwrites. Inside
    `utils.debug.debug_context(eager=True)` a call runs fn eagerly on its
    inputs instead."""

    def __init__(self, fn, example_inputs):
        self.fn = fn
        self.inputs = [x.clone() for x in example_inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, *inputs):
        for static, x in zip(self.inputs, inputs):
            if static.shape != x.shape:
                raise ValueError(f"captured for inputs of shape "
                                 f"{tuple(static.shape)}, got "
                                 f"{tuple(x.shape)}")
        if debug.eager():
            return self.fn(*inputs)
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        return self.outputs


class BucketedReceiver:
    """Per-bucket engines with pad-to-bucket dispatch.

    make_engine: n_prb -> `AerialNRX` of that width. params: the CGNN
    parameters ({"cgnn": tree}, packed for the engines' dtype). graphs:
    serve each (bucket, valid width) from a CUDA graph (a CUDA device
    only), captured at construction for every bucket's full width and at
    the first request for any other width; else every call runs eagerly.
    batch_size: the batch the graphs are captured for.
    """

    def __init__(self, make_engine, params, batch_size: int = 1,
                 buckets=DEFAULT_PRB_BUCKETS, graphs: bool = False):
        self.buckets = tuple(sorted(buckets))
        self.params = params
        self.batch_size = batch_size
        self.engines = {n: make_engine(n) for n in self.buckets}
        self.graphs = graphs
        if graphs and any(e.device.type != "cuda"
                          for e in self.engines.values()):
            raise ValueError("graph mode needs engines on a CUDA device")
        self._scatter: dict = {}
        self._captured: dict = {}
        self.capture_seconds: dict = {}
        if graphs:
            for n in self.buckets:
                self.captured(n)

    def bucket_for(self, n_prb: int) -> int:
        for b in self.buckets:
            if n_prb <= b:
                return b
        raise ValueError(f"{n_prb} PRBs exceeds the largest bucket, "
                         f"{self.buckets[-1]}")

    def pilot_scatter(self, bucket: int, valid_sc: int) -> torch.Tensor:
        """[T, P_valid] int64 on the engine's device: the bucket's pilots
        whose subcarrier lies in the valid region, per layer, the positions
        a request's pilot axis maps to (both enumerations are (sym, sc)
        ordered)."""
        key = (bucket, valid_sc)
        if key not in self._scatter:
            eng = self.engines[bucket]
            idx = [np.flatnonzero(p < valid_sc) for p in eng.pilot_sc]
            if len({len(i) for i in idx}) != 1:
                raise ValueError("the layers' valid pilot counts differ")
            self._scatter[key] = torch.as_tensor(np.stack(idx),
                                                 device=eng.device)
        return self._scatter[key]

    def example_inputs(self, n_prb: int, batch: int | None = None,
                       seed: int = 0) -> tuple:
        """Seeded normal inputs of a request at n_prb (all layers active)
        on the engines' device."""
        eng = self.engines[self.bucket_for(n_prb)]
        b = batch or self.batch_size
        sc, t = 12 * n_prb, eng.num_layers
        n_pil = self.pilot_scatter(self.bucket_for(n_prb), sc).shape[1]
        n_sym, ant = eng.tables["pe"].shape[1], eng.cfg.num_rx_ant
        rng = np.random.default_rng(seed)

        def normal(*shape):
            return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                                   device=eng.device)
        return (normal(b, sc, n_sym, ant), normal(b, sc, n_sym, ant),
                normal(b, n_pil, t, ant), normal(b, n_pil, t, ant),
                torch.ones((b, t), device=eng.device))

    def _check(self, n_prb: int, h_hat_real) -> tuple[int, int]:
        bucket = self.bucket_for(n_prb)
        eng, valid_sc = self.engines[bucket], 12 * n_prb
        if valid_sc != eng.n_sc and not eng.pad_dispatch_exact:
            # e.g. type-2 DMRS: the bucket's gather could take a pilot
            # from a later PRB that arrives zero-padded
            raise ValueError(
                f"engine for bucket {bucket} cannot serve {n_prb} PRBs by "
                "padding (pilot gathers cross PRB boundaries); build an "
                "engine of this PRB count instead")
        want = self.pilot_scatter(bucket, valid_sc).shape[1]
        if h_hat_real.shape[1] != want:
            raise ValueError(f"expected {want} pilots for {n_prb} PRBs, "
                             f"got {h_hat_real.shape[1]}")
        return bucket, valid_sc

    def eager(self, n_prb: int, rx_slot_real, rx_slot_imag, h_hat_real,
              h_hat_imag, dmrs_port_mask):
        """The dispatch without a graph: (llr, h_hat) of the request,
        Aerial layout, cropped to 12 n_prb subcarriers."""
        bucket, valid_sc = self._check(n_prb, h_hat_real)
        eng = self.engines[bucket]
        pad = eng.n_sc - valid_sc
        if pad == 0:
            return eng(self.params, rx_slot_real, rx_slot_imag, h_hat_real,
                       h_hat_imag, dmrs_port_mask, num_valid_sc=valid_sc)
        idx = self.pilot_scatter(bucket, valid_sc)

        def scatter(h):  # [b, P_valid, T, ant] -> [b, P_bucket, T, ant]
            out = h.new_zeros((h.shape[0], eng.num_pilots) + h.shape[2:])
            for tx in range(idx.shape[0]):
                out[:, idx[tx], tx] = h[:, :, tx]
            return out

        llr, h_hat = eng(self.params,
                         F.pad(rx_slot_real, (0, 0, 0, 0, 0, pad)),
                         F.pad(rx_slot_imag, (0, 0, 0, 0, 0, pad)),
                         scatter(h_hat_real), scatter(h_hat_imag),
                         dmrs_port_mask, num_valid_sc=valid_sc)
        return llr[:, :, :valid_sc], h_hat[:, :, :valid_sc]

    def captured(self, n_prb: int) -> CapturedCall:
        """The CUDA graph of requests at n_prb, captured at first use."""
        key = (self.bucket_for(n_prb), 12 * n_prb)
        if key not in self._captured:
            t0 = time.perf_counter()
            self._captured[key] = CapturedCall(
                lambda *a: self.eager(n_prb, *a),
                self.example_inputs(n_prb))
            self.capture_seconds[key] = time.perf_counter() - t0
        return self._captured[key]

    def run(self, n_prb: int, rx_slot_real, rx_slot_imag, h_hat_real,
            h_hat_imag, dmrs_port_mask):
        """(llr, h_hat) of a request at n_prb (Aerial layout, cropped):
        from its CUDA graph in graph mode (the graph's output tensors,
        valid until the next request at this width), else eagerly."""
        inputs = (rx_slot_real, rx_slot_imag, h_hat_real, h_hat_imag,
                  dmrs_port_mask)
        if not self.graphs:
            return self.eager(n_prb, *inputs)
        self._check(n_prb, h_hat_real)
        return self.captured(n_prb)(*inputs)


def save_engine(path: str, engine: AerialNRX, params) -> int:
    """Write the engine (static tables, configuration) and its parameters
    to `path` (`torch.save`); returns the byte size. The file rebuilds the
    engine without a configuration file, `Parameters` or the tables'
    pre-computation (`load_engine`)."""
    tables = {k: v.cpu() for k, v in engine.tables.items()}
    leaves = {k: v.detach().float().cpu()
              for k, v in weights.flatten(params["cgnn"]).items()}
    torch.save({"format": ENGINE_FORMAT, "tables": tables,
                "pad_dispatch_exact": engine.pad_dispatch_exact,
                "n_prb": engine.n_sc // 12, "params": leaves,
                **engine.config()}, path)
    return os.path.getsize(path)


def load_engine(path: str, device="cuda") -> tuple[AerialNRX, dict]:
    """(engine, params) from a `save_engine` file, the parameters on
    `device` and packed for the engine's kernels."""
    from ..entry import pack_params
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if blob.get("format") != ENGINE_FORMAT:
        raise ValueError(f"{path} is not an engine file ({ENGINE_FORMAT})")
    dtype = getattr(torch, blob["dtype"])
    tables = {k: blob["tables"][k].numpy() for k in TABLE_NAMES}
    tables["pad_dispatch_exact"] = blob["pad_dispatch_exact"]
    engine = AerialNRX(tables, CGNNConfig(**blob["cgnn_cfg"]),
                       num_it=blob["num_it"], dtype=dtype,
                       mcs_idx=blob["mcs_idx"], device=device)
    tree = weights.from_jax_numpy(weights.unflatten(
        {k: v.numpy() for k, v in blob["params"].items()}), device=device)
    return engine, pack_params({"cgnn": tree}, dtype)


def measure_latency(fn, inputs, iters: int = 100, batch: int = 1) -> dict:
    """Host latency of one synchronised call fn(*inputs) (p50, p99 ms),
    pipelined calls and slots per second (back-to-back calls, one
    synchronise at the end), and on a CUDA device the mean ms per call
    between CUDA events over back-to-back calls ("event_ms", None on the
    CPU: not measured)."""
    cuda = inputs[0].device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    fn(*inputs)
    sync()
    lat = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*inputs)
        sync()
        lat.append(time.perf_counter() - t0)
    lat_ms = np.asarray(lat) * 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*inputs)
    sync()
    calls = iters / (time.perf_counter() - t0)
    event_ms = None
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*inputs)
        end.record()
        end.synchronize()
        event_ms = start.elapsed_time(end) / iters
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "calls_per_s": calls, "slots_per_s": calls * batch,
            "event_ms": event_ms}


def engine_config(cfg: CGNNConfig, fused_convs: bool = True,
                  fused_iteration: bool = True,
                  mega: bool = False) -> CGNNConfig:
    """The engine's route on a receiver's CGNN configuration: the export's
    default is the stack kernel for the init stack and the iteration
    kernel for every iteration (K1 + K3 at every batch); mega: the
    whole-CGNN kernel (K4)."""
    return dataclasses.replace(cfg, fused_convs=fused_convs,
                               fused_iteration=fused_iteration,
                               fused_readout=False, fused_full=mega)
