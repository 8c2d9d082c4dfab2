"""The port's spans (utils/profiling.py): the tree a training block emits
under a profiler, nothing entered without one, every call site named in
SPANS, the attribution of kernels to spans on a planted trace, and the
rate the train CLIs print, between report reads, on a planted clock."""

import ast
import glob
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.cli import clstmfiltertrain, clstmocrtrain  # noqa: E402
from clstm_tpu_torch.data.device_cache import (  # noqa: E402
    DeviceDataset, TextDeviceDataset)
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR, CLSTMText  # noqa: E402
from clstm_tpu_torch.ops.bidi_lstm_kernel import hoists_projection  # noqa: E402,E501
from clstm_tpu_torch.utils import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _samples(n: int, D: int, T: int = 24, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(T, D).astype(np.float32),
             "".join(rng.choice(list("abc "), size=5))) for _ in range(n)]


def _ocr(samples, D: int, bf16: bool = False):
    codec = Codec.build([t for _, t in samples])
    ocr = CLSTMOCR(target_height=D, dewarp="none", device=CPU)
    ocr.createBidi(codec, 4, seed=1)
    ocr.setLearningRate(1e-3, 0.9)
    ocr.xz_bf16 = bf16
    return ocr, codec


def _parents(spans):
    """Each span's innermost enclosing span (any thread), or None."""
    out = []
    for name, _, s, e in spans:
        up = [(s2, n2) for n2, _, s2, e2 in spans
              if (s2, e2) != (s, e) and s2 <= s and e <= e2]
        out.append((name, max(up)[1] if up else None))
    return out


BASE = {"clstm.plan": None, "clstm.block": None, "clstm.step": "clstm.block",
        "clstm.gather": "clstm.step", "clstm.lstm.fwd": "clstm.step",
        "clstm.affine.fwd": "clstm.step", "clstm.loss": "clstm.step",
        "clstm.ctc": "clstm.step", "clstm.backward": "clstm.step",
        "clstm.lstm.bwd": "clstm.backward", "clstm.update": "clstm.step",
        "clstm.report": "clstm.step"}


@pytest.mark.parametrize("mode,D,bf16,extra", [
    ("f32", 16, False, {}),
    ("bf16", 16, True, {"clstm.affine.bwd": "clstm.backward"}),
    ("hoist", 128, False, {"clstm.hoist": "clstm.lstm.fwd"}),
])
def test_torch_block_emits_the_span_tree(tmp_path, mode, D, bf16, extra):
    """A train_batch_block of a tiny bidi net under profiling.trace: the
    plan, then clstm.block holding one clstm.step per step, each holding
    the gather, the LSTM forward, the affine forward, the loss, the
    alignment, the backward (holding the LSTM backward), the update and
    the report; the bf16 mode adds the affine backward, and a layer that
    hoists its projection adds clstm.hoist inside the LSTM forward."""
    assert hoists_projection(D, 4) == (mode == "hoist")
    samples = _samples(8, D)
    ocr, codec = _ocr(samples, D, bf16)
    dds = DeviceDataset(samples, codec, device=CPU)
    with profiling.trace(str(tmp_path)) as prof:
        block = next(dds.epoch_blocks(4, 2))
        ocr.train_batch_block(block, k_max=2)
    with open(prof.trace_path) as f:
        acc = profiling.span_account(json.load(f)["traceEvents"])
    got = _parents(acc["spans"])
    want = dict(BASE, **extra)
    assert {n: p for n, p in got} == want
    assert sorted(set(got)) == sorted(want.items())
    assert [n for n, _ in got].count("clstm.step") == block["k"] == 2
    assert [n for n, _ in got].count("clstm.block") == 1


class _Counting:
    """torch.profiler.record_function, counting its constructions."""

    def __init__(self):
        self.n = 0
        self.real = torch.profiler.record_function

    def __call__(self, *a, **k):
        self.n += 1
        return self.real(*a, **k)


def test_torch_spans_off_enter_nothing(monkeypatch, tmp_path):
    """With no profiler recording, a whole block (its plan included)
    enters record_function zero times and span() is the shared no-op;
    under a profiler the same block enters it (the counter counts)."""
    counter = _Counting()
    monkeypatch.setattr(torch.profiler, "record_function", counter)
    samples = _samples(8, 16)
    ocr, codec = _ocr(samples, 16)
    dds = DeviceDataset(samples, codec, device=CPU)
    gen = dds.epoch_blocks(4, 2, epochs=2)
    ocr.train_batch_block(next(gen), k_max=2)
    assert counter.n == 0
    assert profiling.span("clstm.step") is profiling._OFF
    with profiling.trace(str(tmp_path)):
        ocr.train_batch_block(next(gen), k_max=2)
        assert profiling.span("clstm.step") is not profiling._OFF
    assert counter.n > 0


def test_torch_every_span_call_names_an_entry_of_spans():
    """Every span(...) call in clstm_tpu_torch/ names a SPANS entry by a
    string literal, and every entry has a call site."""
    used, bad = set(), []
    for path in glob.glob(os.path.join(ROOT, "clstm_tpu_torch", "**",
                                       "*.py"), recursive=True):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", "")) ==
                    "span"):
                continue
            arg = node.args[0] if len(node.args) == 1 else None
            if (isinstance(arg, ast.Constant) and not node.keywords
                    and arg.value in profiling.SPANS):
                used.add(arg.value)
            else:
                bad.append((os.path.relpath(path, ROOT), node.lineno))
    assert not bad, bad
    assert used == set(profiling.SPANS)


def _x(name, cat, tid, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
          "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# Main thread 1, the autograd engine's thread 2; times in us.
PLANTED = [
    _x("portbench.window", "user_annotation", 1, 0, 200),
    _x("clstm.step", "user_annotation", 1, 0, 100),
    _x("clstm.lstm.fwd", "user_annotation", 1, 10, 20),
    _x("clstm.hoist", "user_annotation", 1, 12, 6),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 13, 1, 1),
    _x("cudaLaunchKernelExC", "cuda_runtime", 1, 20, 1, 2),
    _x("clstm.backward", "user_annotation", 1, 60, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 2, 65, 1, 3),
    _x("clstm.lstm.bwd", "user_annotation", 2, 70, 10),
    _x("cuLaunchKernelEx", "cuda_driver", 2, 72, 1, 4),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 110, 1, 5),
    _x("clstm.plan", "user_annotation", 1, 130, 10),
    _x("clstm.report.wait", "user_annotation", 1, 160, 10),
    _x("gemm", "kernel", 7, 40, 5, 1),
    _x("fwd16_kernel", "kernel", 7, 50, 10, 2),
    _x("log_softmax_backward", "kernel", 7, 70, 4, 3),
    _x("bwd_chain16_kernel", "kernel", 7, 80, 6, 4),
    _x("fill", "kernel", 7, 120, 3, 5),
    _x("orphan", "kernel", 7, 150, 2, 99),
    _x("late", "kernel", 7, 198, 4, 1),
]


def test_torch_span_account_on_a_planted_trace():
    """The attribution rule: a kernel goes to the innermost span open on
    its launching thread when the launch starts (the nested clstm.hoist;
    the autograd thread's own clstm.lstm.bwd), else to the innermost span
    open on any thread (the autograd thread's launch under the main
    thread's clstm.backward); a launch under no span, and a kernel with no
    launch in the trace, are unattributed; a kernel counts by its part
    inside the window."""
    acc = profiling.span_account(PLANTED, window="portbench.window")
    assert acc["window_us"] == 200
    assert [(k[0], k[3]) for k in acc["kernels"]] == [
        ("gemm", "clstm.hoist"), ("fwd16_kernel", "clstm.lstm.fwd"),
        ("log_softmax_backward", "clstm.backward"),
        ("bwd_chain16_kernel", "clstm.lstm.bwd"), ("fill", None),
        ("orphan", None), ("late", "clstm.hoist")]
    assert acc["device_us"] == {"clstm.hoist": 7, "clstm.lstm.fwd": 10,
                                "clstm.backward": 4, "clstm.lstm.bwd": 6}
    assert acc["launches"] == {"clstm.hoist": 2, "clstm.lstm.fwd": 1,
                               "clstm.backward": 1, "clstm.lstm.bwd": 1}
    assert acc["unattributed_us"] == 5
    assert acc["busy_us"] == 32
    # The step's 100 us less its four launch calls.
    assert acc["step_host_us"] == [96]
    assert acc["idle_us"] == {
        "clstm.step": 75, "clstm.plan": 10, "clstm.report": 0,
        "clstm.report.wait": 10, "clstm.decode": 0, "clstm.block": 0,
        "other": 73}
    assert "portbench.window" not in {s[0] for s in acc["spans"]}


def _clock():
    """A planted clock: its c-th reading is 0.01 c^2 s."""
    calls = iter(range(10 ** 6))
    return lambda: 0.01 * next(calls) ** 2


def _ocr_rates(tmp_path):
    samples = _samples(16, 16, T=20, seed=2)
    ocr, codec = _ocr(samples, 16)
    log = tmp_path / "ocr.jsonl"
    clstmocrtrain.train(
        ocr, codec, save_name=str(tmp_path / "ocr"), ntrain=32,
        batch_size=4, report_every=1, save_every=10 ** 6,
        test_every=10 ** 6, steps_per_dispatch=2, log_jsonl=str(log),
        dcache=DeviceDataset(samples, codec, device=CPU))
    return [json.loads(ln)["lines_per_sec"]
            for ln in log.read_text().splitlines()]


def _filter_rates(tmp_path):
    rng = np.random.RandomState(3)
    pairs = [("".join(rng.choice(list("ache"), size=4)),) * 2
             for _ in range(16)]
    icodec = Codec.build([a for a, _ in pairs])
    model = CLSTMText(device=CPU)
    model.createBidi(icodec, Codec.build([b for _, b in pairs]), 4, seed=0)
    model.setLearningRate(1e-3, 0.9)
    recs = []
    log = types.SimpleNamespace(write=lambda **r: recs.append(r))
    clstmfiltertrain.train_blocks(
        model, TextDeviceDataset(pairs, model.icodec, model.codec,
                                 device=CPU), None,
        ntrain=32, batch_size=4, block_k=2, report_every=1,
        save_every=10 ** 6, test_every=10 ** 6,
        save_name=str(tmp_path / "filter"), rng=np.random.RandomState(0),
        log=log)
    return [r["pairs_per_sec"] for r in recs]


@pytest.mark.parametrize("run", [_ocr_rates, _filter_rates],
                         ids=["clstmocrtrain", "clstmfiltertrain"])
def test_torch_train_cli_prints_the_rate_between_report_reads(
        tmp_path, monkeypatch, run):
    """16 lines in batches of 4, blocks of 2 batches, a report every
    trial: four reads of 8 trials each. On a clock read once at the loop's
    start and once a read, at 0, 0.01, 0.04, 0.09 and 0.16 s, every report
    of a read prints 8 trials over the time since the last read (800,
    266.7, 160, 114.3 lines/s), not the trials since the start over the
    time since it (800, 400, 266.7, 200)."""
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        time=_clock()))
    rates = run(tmp_path)
    want = [8 / (0.01 * (2 * i - 1)) for i in (1, 2, 3, 4)]
    np.testing.assert_allclose(rates, np.repeat(want, 2), rtol=1e-9)
