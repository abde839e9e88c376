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
"""

from __future__ import annotations

import os

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
    reproduces no committed curve, ROADMAP.md C4; nrx_site_specific_100k).
    Each `.npz` is named after the JAX pickle it was converted from."""
    path = ema_weights(label, weights_dir)
    other = os.path.join(weights_dir, f"{label}_weights.npz")
    return other if not os.path.exists(path) and os.path.exists(other) \
        else path


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
    with np.load(path) as f:
        leaves = {k: f[k] for k in f.files}
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


def save(path: str, params: dict) -> None:
    """Write params ({"cgnn": tree} and an optional "constellation" list)
    as an `.npz` of named float32 leaves that `load_tree` reads."""
    leaves = flatten(params["cgnn"])
    if "constellation" in params:
        leaves.update(flatten({"constellation": params["constellation"]}))
    arrays = {k: v.detach().float().cpu().numpy() for k, v in leaves.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)
