"""The port's utilities and public names against the JAX package, on CPU:
tests/test_utils.py's env getters, text, Display and meters; the
torch.profiler trace; data/synth.py; network_info, walk_weights, noutput_of
and lstm_init; and the names the JAX package exports, each present in the
port or in its stated exceptions."""

import ast
import glob
import importlib
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu.data.synth import delayed_sequence_batch as jsynth  # noqa: E402
from clstm_tpu.models import prefab as jprefab  # noqa: E402
from clstm_tpu.models import spec as jspec  # noqa: E402
from clstm_tpu_torch.convert import params_from_numpy  # noqa: E402
from clstm_tpu_torch.data.synth import delayed_sequence_batch  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models import spec as tspec  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.utils.config import (  # noqa: E402
    getbenv, getdenv, getienv, getsenv)
from clstm_tpu_torch.utils.display import Display  # noqa: E402
from clstm_tpu_torch.utils.profiling import Throughput, Timer, trace  # noqa: E402
from clstm_tpu_torch.utils.text import read_text, split  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Public names of the JAX package with no counterpart in the port, and why.
EXCEPTIONS = {
    # t_buckets=auto, left out (ROADMAP.md Queue 1).
    "clstm_tpu/data/dataset.py": {"auto_t_cuts"},
    "clstm_tpu/data/device_cache.py": {"measure_dispatch_penalty_rows"},
    # Protobuf messages: the port writes .clstm by hand, without protobuf.
    "clstm_tpu/io/proto.py": {"proto_of_net", "net_of_proto"},
    "clstm_tpu/io/clstm_pb2.py": None,
    # XLA's compilation cache: the port compiles nothing ahead.
    "clstm_tpu/utils/config.py": {"enable_compile_cache"},
    # The Pallas kernels: ported as csrc/*.cu behind ops/*_kernel.py.
    "clstm_tpu/ops/pallas_lstm.py": None,
    "clstm_tpu/ops/pallas_ctc.py": None,
    # A kind's registry entry is its nn.Module class (models/spec.py).
    "clstm_tpu/models/spec.py": {"LayerDef"},
    # The mesh axis and batch sharding of jax.sharding: a rank takes its
    # rows with shard_rows.
    "clstm_tpu/parallel/mesh.py": {"DATA_AXIS", "shard_batch"},
}


def test_torch_env_getters(monkeypatch):
    monkeypatch.setenv("x_int", "42")
    monkeypatch.setenv("x_float", "2.5e-3")
    monkeypatch.setenv("x_str", "hello")
    monkeypatch.setenv("x_bool", "false")
    monkeypatch.setenv("x_yes", "1")
    assert getienv("x_int", 0) == 42
    assert getienv("missing", 7) == 7
    assert getdenv("x_float", 0.0) == 2.5e-3
    assert getsenv("x_str") == "hello"
    assert getbenv("x_bool", True) is False
    assert getbenv("missing", True) is True
    assert getbenv("x_yes") is True


def test_torch_read_text_strips_newline(tmp_path):
    f = tmp_path / "t.gt.txt"
    f.write_bytes("héllo wörld\n".encode("utf-8"))
    assert read_text(str(f)) == "héllo wörld"
    f.write_bytes(b"crlf\r\n")
    assert read_text(str(f)) == "crlf"
    assert split("a  b\tc") == ["a", "b", "c"]


def test_torch_display_renders(tmp_path):
    d = Display(str(tmp_path / "dash.png"))
    for i in range(10):
        d.add_loss(i, 10.0 / (i + 1))
    d.add_test_err(5, 0.3)
    path = d.render(frame_probs=np.random.rand(50, 4),
                    image=np.random.rand(32, 100))
    assert path and os.path.exists(path)


def test_torch_throughput_and_timer():
    t = Throughput()
    assert t.rate() == 0.0
    for _ in range(5):
        t.add(10)
    assert t.total == 50
    assert t.rate() >= 0.0
    assert Timer().elapsed() >= 0.0


def test_torch_trace_writes_chrome_trace(tmp_path):
    """On the CPU trace() records CPU activity only and writes one Chrome
    trace naming the operations run inside it."""
    logdir = str(tmp_path / "tr")
    with trace(logdir) as prof:
        torch.mm(torch.rand(8, 8), torch.rand(8, 8))
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert files == [prof.trace_path]
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert (prof.kernel_records, prof.kernel_launches) == (0, 0)


def test_torch_trace_warns_of_lost_kernel_records(tmp_path, monkeypatch):
    """A trace whose kernel records fall short of its kernel launches comes
    back with a RuntimeWarning naming both counts; a whole one with none.
    The CPU launches no kernel, so the counts are planted."""
    import warnings
    from clstm_tpu_torch.utils import profiling
    for counts, warned in (((77, 112), True), ((112, 112), False)):
        monkeypatch.setattr(profiling, "kernel_counts", lambda p, c=counts: c)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            with trace(str(tmp_path / "tr")) as prof:
                torch.mm(torch.rand(4, 4), torch.rand(4, 4))
        lost = [w for w in got if issubclass(w.category, RuntimeWarning)
                and "77 kernel records of 112" in str(w.message)]
        assert (prof.kernel_records, prof.kernel_launches) == counts
        assert bool(lost) == warned, [str(w.message) for w in got]


@pytest.mark.parametrize("seed,delay", [(0, 1), (1, 2), (2, 0), (3, 5)])
def test_torch_synth_matches_jax_copy(seed, delay):
    got = delayed_sequence_batch(np.random.RandomState(seed), 4, 9, 5, delay)
    want = jsynth(np.random.RandomState(seed), 4, 9, 5, delay)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("kind,args", [
    ("bidi", {"ninput": 3, "nhidden": 4, "noutput": 3}),
    ("bidi2", {"ninput": 4, "nhidden": 6, "noutput": 5, "nhidden2": 3}),
    ("lstm1", {"ninput": 4, "nhidden": 6, "noutput": 5}),
])
def test_torch_network_info_walk_weights_noutput(kind, args):
    """The same text, weight paths, names and shapes as the JAX package's
    for the same spec and weights (tests/test_layers.py)."""
    spec, params = jprefab.make_net_init(kind, args, jax.random.PRNGKey(0))
    tspec_ = tprefab.make_net(kind, args)
    net = params_from_numpy(tspec_, jax.tree.map(np.asarray, params))
    assert tspec.network_info(tspec_, net) == jspec.network_info(spec, params)
    assert tspec.network_info(tspec_) == jspec.network_info(spec)
    got = [(p, n, tuple(a.shape), a.detach().numpy())
           for p, n, a in tspec.walk_weights(tspec_, net)]
    want = [(p, n, tuple(a.shape), np.asarray(a))
            for p, n, a in jspec.walk_weights(spec, params)]
    assert [g[:3] for g in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[3], w[3])
    for s, t in zip(_nodes(spec), _nodes(tspec_)):
        assert tspec.noutput_of(t) == jspec.noutput_of(s)


def _nodes(spec):
    yield spec
    for s in spec.sub:
        yield from _nodes(s)


def test_torch_lstm_init_is_the_layer_init():
    """lstm_init draws Wx, Wh, b in the NPLSTM layer's order, uniform in
    ±scale; GATE_ORDER is the JAX package's."""
    from clstm_tpu.ops.lstm import GATE_ORDER
    assert tlstm.GATE_ORDER == GATE_ORDER
    p = tlstm.lstm_init(torch.Generator().manual_seed(3), 5, 4, scale=0.2)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "Wx": (5, 16), "Wh": (4, 16), "b": (16,)}
    assert all(float(v.abs().max()) <= 0.2 for v in p.values())
    spec = tspec.layer("NPLSTM", 5, 4, {"nhidden": 4, "initial": 0.2})
    net = tspec.init_net(spec, torch.Generator().manual_seed(3))
    for k, v in net.weights().items():
        assert torch.equal(v.detach(), p[k])


def _exports(pkg: str) -> list:
    return list(importlib.import_module(pkg).__all__)


@pytest.mark.parametrize("pkg", ["", ".models", ".ops", ".io", ".utils",
                                 ".parallel"])
def test_torch_package_exports_cover_jax(pkg):
    """Every name in a JAX package's __all__ is in the port's counterpart's
    __all__ and importable from it, or is one of the stated exceptions."""
    want = set(_exports("clstm_tpu" + pkg))
    got = set(_exports("clstm_tpu_torch" + pkg))
    allowed = set().union(*(v for v in EXCEPTIONS.values() if v))
    assert want - got <= allowed, sorted(want - got - allowed)
    mod = importlib.import_module("clstm_tpu_torch" + pkg)
    assert all(hasattr(mod, n) for n in got)


def _public_names(path: str, with_imports: bool) -> set:
    names = set()
    with open(path, encoding="utf-8") as f:
        body = ast.parse(f.read()).body
    for n in body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            names.add(n.target.id)
        elif with_imports and isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update(a.asname or a.name for a in n.names)
    return {n for n in names if not n.startswith("_")}


def test_torch_public_names_of_every_module():
    """Every public top-level name of every module of clstm_tpu/ is found
    in the port's module of the same path, or is a stated exception."""
    missing = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "clstm_tpu", "**",
                                              "*.py"), recursive=True)):
        rel = os.path.relpath(path, ROOT)
        skip = EXCEPTIONS.get(rel, set())
        if skip is None:
            continue
        port = os.path.join(ROOT, rel.replace("clstm_tpu", "clstm_tpu_torch",
                                              1))
        have = (_public_names(port, True) if os.path.exists(port) else set())
        lack = _public_names(path, False) - have - skip
        if lack:
            missing[rel] = sorted(lack)
    assert not missing, missing
