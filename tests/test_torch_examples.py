"""The torch quickstarts (examples/*_torch.py) run end to end on the CPU at
a small size, and import no JAX (in a subprocess, as a user runs them)."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(ROOT, "examples", name)
    spec = importlib.util.spec_from_file_location(name[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_ocr_quickstart_small(capsys):
    err = _load("ocr_quickstart_torch.py").main(device="cpu", lines=6,
                                                epochs=2, nhidden=8)
    out = capsys.readouterr().out
    assert np.isfinite(err) and 0 <= err
    assert "epoch 2: loss" in out and "round-tripped" in out


def test_torch_filter_quickstart_small(capsys):
    err = _load("filter_quickstart_torch.py").main(device="cpu", pairs=60,
                                                   epochs=2, nhidden=8)
    out = capsys.readouterr().out
    assert np.isfinite(err) and 0 <= err
    assert "epoch 2: test CER" in out and "saved + reloaded" in out


def test_torch_quickstarts_import_no_jax():
    code = ("import runpy, sys; sys.argv = ['x', '--help']\n"
            "for n in ('ocr', 'filter'):\n"
            "    try:\n"
            "        runpy.run_path(f'examples/{n}_quickstart_torch.py',\n"
            "                       run_name='__main__')\n"
            "    except SystemExit:\n"
            "        pass\n"
            "assert 'jax' not in sys.modules and 'clstm_tpu' not in "
            "sys.modules\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "--device" in r.stdout
