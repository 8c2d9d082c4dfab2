"""The port's enable_compile_cache (utils/config.py), on CPU: the directory
the CUDA kernels' library is built into and loaded from
(ops/_build.py BUILD_DIR), with the JAX package's contract for its XLA
cache: "" -> $compile_cache -> the default; "off"/"0" -> a temporary
directory of the process, removed at exit, and ""; any other value is a
directory, created. Nothing is compiled by the call, and each of the four
CLIs calls it at startup."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.cli import (  # noqa: E402
    clstmfilter, clstmfiltertrain, clstmocr, clstmocrtrain)
from clstm_tpu_torch.ops import _build  # noqa: E402
from clstm_tpu_torch.utils import config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_build_dir(monkeypatch):
    """Each test sets the build directory; the next starts from the
    default. nvcc must not run: a build here would be a test failure."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv("compile_cache", raising=False)

    def no_nvcc():
        raise AssertionError("enable_compile_cache compiled something")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)


@pytest.mark.parametrize("mode", ["default", "env", "path", "off", "0"])
def test_torch_enable_compile_cache_sets_build_dir(mode, tmp_path,
                                                  monkeypatch):
    where = tmp_path / "kernels" / "cache"
    arg = {"default": "", "env": "", "path": str(where), "off": "off",
           "0": "0"}[mode]
    if mode == "env":
        monkeypatch.setenv("compile_cache", str(where))
    got = config.enable_compile_cache(arg)
    lib = _build.library_path()
    if mode == "default":
        assert got == str(_build.DEFAULT_BUILD_DIR)
        assert lib.parent == _build.DEFAULT_BUILD_DIR
    elif mode in ("env", "path"):
        assert got == str(where) and where.is_dir()
        assert lib.parent == where and list(where.iterdir()) == []
    else:
        assert got == ""
        assert lib.parent != _build.DEFAULT_BUILD_DIR
        assert lib.parent.is_dir() and list(lib.parent.iterdir()) == []
    assert lib.name.startswith("libclstm_kernels-")
    assert not lib.exists()


def test_torch_enable_compile_cache_off_leaves_nothing(tmp_path):
    """"off" in a fresh process: its directory exists while the process
    runs and is gone after it exits."""
    env = dict(os.environ, PYTHONPATH=ROOT, TMPDIR=str(tmp_path))
    code = ("from clstm_tpu_torch.utils.config import enable_compile_cache;"
            "from clstm_tpu_torch.ops import _build;"
            "import os;"
            "assert enable_compile_cache('off') == '';"
            "d = _build.library_path().parent;"
            "assert d.is_dir();"
            "print(d)")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout.strip()
    assert out.startswith(str(tmp_path)) and not os.path.exists(out)
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("cli", ["clstmocr", "clstmocrtrain",
                                 "clstmfiltertrain", "clstmfilter"])
def test_torch_clis_call_enable_compile_cache(cli, monkeypatch, capsys):
    """Each CLI's main passes $compile_cache to enable_compile_cache before
    it loads or trains anything."""
    mod = {"clstmocr": clstmocr, "clstmocrtrain": clstmocrtrain,
           "clstmfiltertrain": clstmfiltertrain,
           "clstmfilter": clstmfilter}[cli]
    calls = []
    monkeypatch.setattr(mod, "enable_compile_cache", calls.append)
    monkeypatch.setenv("compile_cache", "somewhere")
    if hasattr(mod, "run_ranks"):
        monkeypatch.setattr(mod, "run_ranks", lambda *a: 0)
    monkeypatch.delenv("load", raising=False)
    mod.main(["in.files"])
    assert calls == ["somewhere"]
