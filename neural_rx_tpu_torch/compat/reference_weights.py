"""The reference's weight files (Keras `get_weights()` pickles) to and from
the port's CGNN parameter tree.

The port's counterpart of `neural_rx_tpu/compat/reference_weights.py`,
with its order and layout translations. A file is a pickled list of numpy
arrays in layer-creation order: the init stacks (one per MCS, or one with
var-MCS masking), then per iteration the aggregation MLP and the update
stack, then the LLR readouts (per MCS, or one) and the channel readout; an
end-to-end configuration's trainable constellations ([2, 2^m] re/im
arrays) come first, as the reference creates its transmitters before its
receiver. Per layer:

- a separable conv's depthwise kernel [3, 3, C_in, 1] is the port's
  [3, 3, 1, C_in] after `transpose(1, 0, 3, 2)`, which also swaps H and W
  (the reference's grid is [subcarrier, symbol], the port's [symbol,
  subcarrier]); its pointwise kernel [1, 1, C_in, C_out] is the port's
  [C_in, C_out] (`[0, 0]`); its bias is the same;
- a dense layer's kernel and bias are the same.

Files are read with an unpickler that builds numpy arrays and lists only.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch

_NUMPY_GLOBALS = {("numpy.core.multiarray", "_reconstruct"),
                  ("numpy._core.multiarray", "_reconstruct"),
                  ("numpy.core.multiarray", "scalar"),
                  ("numpy._core.multiarray", "scalar"),
                  ("numpy", "ndarray"), ("numpy", "dtype")}


class _ArrayUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(
                f"a reference weight file holds numpy arrays, not "
                f"{module}.{name}")
        return super().find_class(module, name)


def read_weight_list(path: str) -> list:
    """The list of arrays of a reference weight file."""
    with open(path, "rb") as f:
        wl = _ArrayUnpickler(f).load()
    if not isinstance(wl, list):
        raise ValueError(f"{path}: a weight file holds a list, not "
                         f"{type(wl).__name__}")
    return [np.asarray(a) for a in wl]


class _Cursor:
    def __init__(self, arrays):
        self.arrays = arrays
        self.i = 0

    def take(self, shape) -> np.ndarray:
        if self.i >= len(self.arrays):
            raise ValueError(f"the weight list ends after {self.i} arrays: "
                             "architecture mismatch")
        a = self.arrays[self.i]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"weight {self.i}: shape {tuple(a.shape)}, "
                             f"expected {tuple(shape)}")
        self.i += 1
        return a


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32,
                        device=like.device)


def _load_sepconv(cur, p):
    c, o = p["pw"].shape
    dw = cur.take((3, 3, c, 1))
    pw = cur.take((1, 1, c, o))
    b = cur.take((o,))
    return {"dw": _tensor(np.transpose(dw, (1, 0, 3, 2)), p["dw"]),
            "pw": _tensor(pw[0, 0], p["pw"]), "b": _tensor(b, p["b"])}


def _load_dense(cur, p):
    return {"w": _tensor(cur.take(p["w"].shape), p["w"]),
            "b": _tensor(cur.take(p["b"].shape), p["b"])}


def _load_block(load, cur, p):
    """A conv stack or an MLP: its hidden layers, then its output layer."""
    return {"hidden": [load(cur, lp) for lp in p["hidden"]],
            "out": load(cur, p["out"])}


def import_reference_weights(params: dict, weight_list) -> dict:
    """A reference `get_weights()` list mapped onto the CGNN tree `params`
    (which gives the architecture, e.g. `init_cgnn_params`'s): a new tree
    of float32 tensors on params' devices. Raises ValueError when a shape
    or the array count does not match."""
    cur = _Cursor([np.asarray(a) for a in weight_list])
    out = {
        "s_init": [_load_block(_load_sepconv, cur, p)
                   for p in params["s_init"]],
        "iterations": [{"agg": _load_block(_load_dense, cur, it["agg"]),
                        "update": _load_block(_load_sepconv, cur,
                                              it["update"])}
                       for it in params["iterations"]],
        "readout_llrs": [_load_block(_load_dense, cur, p)
                         for p in params["readout_llrs"]],
        "readout_chest": _load_block(_load_dense, cur,
                                     params["readout_chest"])}
    if cur.i != len(cur.arrays):
        raise ValueError(f"used {cur.i} of {len(cur.arrays)} reference "
                         "arrays: architecture mismatch")
    return out


def load_reference_weights(path: str, params: dict) -> dict:
    """{"cgnn": tree[, "constellation": [...]]} of a reference weight file,
    on the structure of params (the same keys): the constellations, for a
    params with any, are the file's first arrays."""
    wl = read_weight_list(path)
    out = {}
    if "constellation" in params:
        n = len(params["constellation"])
        cur = _Cursor(wl[:n])
        out["constellation"] = [_tensor(cur.take(c.shape), c)
                                for c in params["constellation"]]
        wl = wl[n:]
    out["cgnn"] = import_reference_weights(params["cgnn"], wl)
    return out


def _dump_sepconv(p, out):
    out.append(np.transpose(_np(p["dw"]), (1, 0, 3, 2)))
    out.append(_np(p["pw"])[None, None])
    out.append(_np(p["b"]))


def _dump_dense(p, out):
    out.append(_np(p["w"]))
    out.append(_np(p["b"]))


def _dump_block(dump, p, out):
    for lp in p["hidden"]:
        dump(lp, out)
    dump(p["out"], out)


def _np(t) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def export_reference_weights(params: dict) -> list:
    """The reference's `get_weights()` list of params ({"cgnn": tree[,
    "constellation": ...]} or a CGNN tree): float32 numpy arrays, the
    constellations first."""
    cg = params["cgnn"] if "cgnn" in params else params
    out = [_np(c) for c in params.get("constellation", ())]
    for p in cg["s_init"]:
        _dump_block(_dump_sepconv, p, out)
    for it in cg["iterations"]:
        _dump_block(_dump_dense, it["agg"], out)
        _dump_block(_dump_sepconv, it["update"], out)
    for p in cg["readout_llrs"]:
        _dump_block(_dump_dense, p, out)
    _dump_block(_dump_dense, cg["readout_chest"], out)
    return out


def save_reference_weights(path: str, params: dict) -> None:
    """Write `export_reference_weights(params)` as a reference weight
    file."""
    with open(path, "wb") as f:
        pickle.dump(export_reference_weights(params), f)
