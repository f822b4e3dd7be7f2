"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level name; the reference imports nothing of the program."""

import ast
import sys

import run as bench
from harness import manifest as mf

FORBIDDEN = {"jax", "jaxlib", "flax", "videosys_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_whole_name_check(monkeypatch):
    for name in ("videosys_tpu_torch", "videosys_tpu_torch.ops", "jaxtyping",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = bench.forbidden_modules()
    assert not any(n.startswith(("videosys_tpu_torch", "jaxtyping",
                                 "flaxen")) for n in found)
    for name in ("jax", "jax.numpy", "jaxlib", "flax.linen", "videosys_tpu",
                 "videosys_tpu.ops"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert {"jax", "jax.numpy", "jaxlib", "flax.linen", "videosys_tpu",
            "videosys_tpu.ops"} <= set(bench.forbidden_modules())


def test_no_source_imports_jax_or_the_jax_package():
    for path in mf.BENCH.rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (mf.BENCH / "reference").glob("*.py"):
        names = _imports(path)
        assert "videosys_tpu_torch" not in names, path
        assert names <= {"__future__", "dataclasses", "hashlib", "math",
                         "typing", "numpy", "torch", "reference"}, path


def test_a_run_leaves_no_forbidden_module(tiny):
    import torch
    cfg, mix = tiny("os12-480p-dense")
    bench.run_cell("os12-480p-dense", 7, 0.1, False,
                   device=torch.device("cpu"), cfg=cfg, mix=mix)
    assert bench.forbidden_modules() == []
