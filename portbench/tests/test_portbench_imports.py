"""Nothing the benchmark runs imports JAX or the package the port was made
from, and the reference imports nothing of the program. Module names are
compared by their top-level part (before the first dot) whole:
``clstm_tpu_torch`` begins with ``clstm_tpu`` and is not it."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

from portbench import harness, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "clstm_tpu"}


def _sources(sub=""):
    top = os.path.join(registry.HERE, sub)
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in (".cache", "out",
                                                "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, registry.HERE))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference"))
                         + sorted(_sources(os.path.join("tests",
                                                        "families"))),
                         ids=lambda p: os.path.relpath(p, registry.HERE))
def test_the_reference_imports_nothing_of_the_program(path):
    """The reference and every family's file (a configuration's
    "reference"), those of the tests' families too."""
    allowed = {"__future__", "statistics", "typing", "numpy",
               "torch", "portbench"}
    assert set(_imported(path)) <= allowed


def test_the_names_are_compared_whole(monkeypatch):
    assert set(harness.FORBIDDEN) == FORBIDDEN
    monkeypatch.setitem(sys.modules, "clstm_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxish_probe", sys)
    assert not set(harness.forbidden_modules()) & {"clstm_tpu", "jax"}
    monkeypatch.setitem(sys.modules, "jax.probe", sys)
    assert "jax" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of a cell at a tiny size on the CPU, in a process of its
    own: once it has judged its outputs, sys.modules holds none of them."""
    code = textwrap.dedent("""
        import argparse, sys, time
        sys.path.insert(0, %r)
        from portbench import harness, registry
        man = registry.manifest()
        args = argparse.Namespace(workload="bidi.train", seed=2**31 + 5,
                                  seconds=0.5, trace=0)
        run = harness.Run(man, "bidi.train", args, "cpu", overrides={
            "cfg": {"nhidden_layers": [6], "noutput": 9,
                    "precision": "f32"},
            "mix": {"lines": 24, "width_min": 40, "width_max": 80,
                    "cell_cols": 11, "glyph_cols": [6, 9],
                    "batch_size": 8, "steps_per_dispatch": 3}})
        res = harness.run_cell(run, False, time.time(), man=man)
        assert res["correct"], res
        print("FOUND", harness.forbidden_modules())
    """) % registry.ROOT
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND []" in out.stdout
