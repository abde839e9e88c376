"""The PyTorch port stands alone: `neural_rx_tpu_torch/` and `chip_smoke.py`
import neither JAX nor the JAX package, and the kernel is built with plain
nvcc from a source without PyTorch headers, not replaced by a library call."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "neural_rx_tpu_torch")
PY_FILES = sorted(glob.glob(os.path.join(PORT, "**", "*.py"),
                            recursive=True)) + [
    os.path.join(ROOT, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "neural_rx_tpu", "flax", "optax")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PY_FILES,
                         ids=[os.path.relpath(p, ROOT) for p in PY_FILES])
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {mod}"


# the multi-GPU and tooling modules: each must stay among the files checked
DIST_AND_TOOLS = ("dist/__init__.py", "dist/mesh.py", "dist/multihost.py",
                  "dist/fused_sharded.py", "dist/launch.py",
                  "dist/checks.py", "utils/__init__.py",
                  "utils/profiling.py", "utils/debug.py",
                  "compat/__init__.py", "compat/reference_weights.py",
                  "phy/sources.py", "phy/nr/ldpc_oracle.py",
                  "sim/metrics.py")


@pytest.mark.parametrize("rel", DIST_AND_TOOLS)
def test_dist_and_tool_modules_are_checked(rel):
    path = os.path.join(PORT, *rel.split("/"))
    assert path in PY_FILES
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in FORBIDDEN]


def test_no_library_kernel_in_place_of_ours():
    for path in PY_FILES:
        src = open(path).read()
        for bad in ("cpp_extension", "torch.compile", "conv2d", "conv1d",
                    "scaled_dot_product_attention"):
            assert bad not in src, f"{path} uses {bad}"
    for path in glob.glob(os.path.join(PORT, "csrc", "*")):
        assert "torch/extension.h" not in open(path).read()


def test_build_flags_target_sm90a():
    from neural_rx_tpu_torch.kernels import _build
    flags = " ".join(_build.NVCC_FLAGS)
    link = " ".join(_build.LINK_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "arch=compute_90a,code=sm_90a" in link
    assert "-fPIC" in flags and "-shared" in link
    assert _build.BUILD_DIR.startswith(PORT)
    assert os.path.basename(_build.library_path()).startswith(
        "libnrx_kernels_")


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per source (started together), then one link; the library
    lands in the build directory and is reused while the sources stay."""
    from neural_rx_tpu_torch.kernels import _build
    log = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\necho "$@" >> ' + str(log) + '\n'
                    'while [ $# -gt 1 ]; do [ "$1" = -o ] && touch "$2"; '
                    'shift; done\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    info = _build.build()
    calls = log.read_text().splitlines()
    sources = [s for s in _build._sources() if s.endswith(".cu")]
    assert len(sources) >= 2 and len(calls) == len(sources) + 1
    for src in sources:
        assert sum(f"-c {src} " in c for c in calls) == 1
    assert "-shared" in calls[-1] and calls[-1].count(".o") == len(sources)
    assert os.path.exists(info.path) and info.path == _build.library_path()
    assert not [p for p in os.listdir(tmp_path / "build") if p.endswith(".o")]
    assert _build.build().seconds == 0.0
