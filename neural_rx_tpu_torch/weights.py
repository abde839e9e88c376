"""CGNN weights: the bridge from the JAX package's parameter tree.

The JAX package pickles its trees with a JAX `PyTreeDef`, which needs JAX
to read. `scripts/torch_port_export_weights.py` converts such a file into
an `.npz` of named float32 leaves ("s_init.0.hidden.1.pw", ...: the tree
path, list indices as numbers), which this module reads with numpy alone.
Leaves keep the JAX layout (depthwise kernels stay [3, 3, 1, C]). The port
writes trained parameters in the same format (`save`): the CGNN's leaves
under those names and a trainable constellation's point arrays as
"constellation.0", ... (one per MCS). `load_tree` also reads the
reference's own weight files (`compat/reference_weights.py`), onto the
structure of a template tree.

No weight file is 1,000,000 B or more. A tree whose `.npz` would be that
large is written as parts, `{stem}.part0.npz`, `{stem}.part1.npz`, ...:
its leaves in sorted name order, each part as many as fit under the limit,
each holding `PART_KEY` = [index, count]. `load_tree("{stem}.npz")` reads
the parts where the single file is absent. nrx_large's committed weights
are `nrx_large_weights.part*.npz`, from `nrx_large_weights.pkl`, the file
the JAX package's evaluate CLI loads; its EMA copy is not converted, since
`committed_weights` prefers an EMA file and the port would then evaluate
other weights than that CLI. e2e_rt's are `e2e_rt_ema_weights.part*.npz`,
from `e2e_rt_ema.pkl`, with the learned constellation (the JAX CLI finds no
`e2e_rt_weights.pkl` and evaluates its random init instead).
"""

from __future__ import annotations

import glob
import io
import os
import re

import numpy as np
import torch

from .rx.neural_rx import _to, resolve_device

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "weights")


def ema_weights(label: str, weights_dir: str = WEIGHTS_DIR) -> str:
    """Path of the committed EMA weights of configuration `label`."""
    return os.path.join(weights_dir, f"{label}_ema_weights.npz")


def committed_weights(label: str, weights_dir: str = WEIGHTS_DIR) -> str:
    """Path of the committed weights of configuration `label` in
    weights_dir: its EMA weights, or {label}_weights.npz where only those
    are committed (nrx_rt_var_mcs: the EMA pickle of that configuration
    reproduces no committed curve, ROADMAP.md C4; nrx_site_specific_100k;
    nrx_large). Each `.npz` is named after the JAX pickle it was converted
    from; either may be stored as parts (`exists`)."""
    path = ema_weights(label, weights_dir)
    other = os.path.join(weights_dir, f"{label}_weights.npz")
    return other if not exists(path) and exists(other) else path


PART_LIMIT = 1_000_000  # bytes: every weight file stays under it
PART_KEY = "__part__"  # [index, count] in each part


def part_path(path: str, index: int) -> str:
    """Path of part `index` of the `.npz` path: {stem}.part{index}.npz."""
    return f"{path[:-len('.npz')]}.part{index}.npz"


def _part_glob(path: str) -> list:
    return glob.glob(glob.escape(path[:-len(".npz")]) + ".part*.npz")


def exists(path: str) -> bool:
    """Whether the `.npz` path is on disk, as one file or as parts."""
    return os.path.exists(path) or os.path.exists(part_path(path, 0))


def _part_files(path: str) -> list:
    """The files of the parts of path, in order; raises where a part is
    missing or the parts disagree on their count."""
    stem = re.escape(os.path.basename(path[:-len(".npz")]))
    found = {int(m.group(1)): f for f in _part_glob(path)
             if (m := re.fullmatch(stem + r"\.part(\d+)\.npz",
                                   os.path.basename(f)))}
    if not found:
        raise FileNotFoundError(f"no weights at {path} (nor its parts)")
    with np.load(found[min(found)]) as f:
        count = int(f[PART_KEY][1])
    missing = sorted(set(range(count)) - set(found))
    if missing or len(found) != count:
        raise FileNotFoundError(f"{path}: {count} parts, found "
                                f"{sorted(found)}, missing {missing}")
    return [found[i] for i in range(count)]


def _read_leaves(path: str) -> dict:
    """{name: array} of the `.npz` path, or of its parts where the single
    file is absent; raises where a leaf appears in two parts."""
    if os.path.exists(path):
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    files = _part_files(path)
    leaves = {}
    for i, name in enumerate(files):
        with np.load(name) as f:
            index, count = (int(v) for v in f[PART_KEY])
            if (index, count) != (i, len(files)):
                raise ValueError(f"{name} says part {index} of {count}")
            for k in f.files:
                if k == PART_KEY:
                    continue
                if k in leaves:
                    raise ValueError(f"leaf {k} in two parts of {path}")
                leaves[k] = f[k]
    return leaves


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _split_parts(arrays: dict) -> list:
    """The contents of the files that hold `arrays` ({name: array}): one
    `.npz` where it stays under PART_LIMIT bytes, else parts, the leaves in
    sorted name order, each part as many as fit under it (with its
    PART_KEY)."""
    whole = _npz_bytes(arrays)
    if len(whole) < PART_LIMIT:
        return [whole]
    mark = {PART_KEY: np.zeros(2, np.int64)}
    groups = [{}]
    for name in sorted(arrays):
        trial = {**groups[-1], name: arrays[name]}
        if groups[-1] and len(_npz_bytes({**trial, **mark})) >= PART_LIMIT:
            groups.append({name: arrays[name]})
        else:
            groups[-1] = trial
    parts = [_npz_bytes({**g, PART_KEY: np.array([i, len(groups)],
                                                 np.int64)})
             for i, g in enumerate(groups)]
    too_big = [len(d) for d in parts if len(d) >= PART_LIMIT]
    if too_big:
        raise ValueError(f"a leaf alone takes {max(too_big)} B, over the "
                         f"limit of {PART_LIMIT} B")
    return parts


def write_npz(path: str, arrays: dict) -> list:
    """Write arrays ({name: array}) to the `.npz` path, as one file or as
    parts (`_split_parts`), replacing the file and any parts of an earlier
    write there. Returns the paths written."""
    parts = _split_parts(arrays)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    for name in [path] + _part_glob(path):
        if os.path.exists(name):
            os.remove(name)
    names = [path] if len(parts) == 1 else [
        part_path(path, i) for i in range(len(parts))]
    for name, data in zip(names, parts):
        with open(name, "wb") as f:
            f.write(data)
    return names


NRX_RT_EMA = ema_weights("nrx_rt")


def flatten(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a nested dict/list tree, without the kernels'
    packed weight buffers (a stack's or MLP's "packed" entry, derived from
    its leaves)."""
    if isinstance(tree, dict):
        items = ((k, v) for k, v in tree.items() if k != "packed")
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten(leaves: dict):
    """Inverse of `flatten`: numeric path components become list indices."""
    root: dict = {}
    for name, leaf in leaves.items():
        node = root
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def from_jax_numpy(tree, device="cpu"):
    """The JAX CGNN parameter tree (numpy or array leaves) as the port's
    tree of float32 torch tensors on `device`, same structure and layout."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.tensor(np.asarray(node, np.float32), device=device)

    return conv(tree)


def load_tree(path: str, device="cuda", template: dict | None = None
              ) -> dict:
    """{"cgnn": tree} of an `.npz` of named leaves, with "constellation":
    [one (re, im) point array per MCS] where the file holds one. A path
    not ending in `.npz` is a reference weight file (a pickled Keras
    `get_weights()` list), mapped onto the structure of template ({"cgnn":
    tree[, "constellation": [...]]}, e.g. a model's `init_params`), which
    such a file needs."""
    if not path.endswith(".npz"):
        if template is None:
            raise ValueError(f"{path} is a reference weight file: its tree "
                             "comes from a template")
        from .compat.reference_weights import load_reference_weights
        return _to(load_reference_weights(path, template),
                   resolve_device(device))
    leaves = _read_leaves(path)
    points = {k: v for k, v in leaves.items()
              if k.startswith("constellation.")}
    cgnn = {k: v for k, v in leaves.items() if k not in points}
    params = {"cgnn": from_jax_numpy(unflatten(cgnn), device=device)}
    if points:
        params["constellation"] = from_jax_numpy(
            unflatten(points)["constellation"], device=device)
    return params


def load(path: str = NRX_RT_EMA, device="cuda"):
    """A CGNN parameter tree from an `.npz` of named leaves."""
    return load_tree(path, device)["cgnn"]


def save(path: str, params: dict) -> list:
    """Write params ({"cgnn": tree} and an optional "constellation" list)
    as an `.npz` of named float32 leaves that `load_tree` reads, in parts
    where one file would reach PART_LIMIT. Returns the paths written."""
    leaves = flatten(params["cgnn"])
    if "constellation" in params:
        leaves.update(flatten({"constellation": params["constellation"]}))
    return write_npz(path, {k: v.detach().float().cpu().numpy()
                            for k, v in leaves.items()})
