"""The trace's reduction puts each kernel down to the program's span that
launched it (the port's rule, copied into trace.py), on a planted Chrome
trace: a kernel under a nested span, one launched on the autograd thread
while the main thread waits inside a span, and one outside every span."""

from portbench import trace


def _x(name, cat, tid, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
          "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


# Main thread 1, the autograd engine's thread 2; times in us.
PLANTED = [
    _x("portbench.window", "user_annotation", 1, 0, 200),
    _x("portbench.train_block", "user_annotation", 1, 0, 180),
    _x("clstm.step", "user_annotation", 1, 0, 100),
    _x("clstm.lstm.fwd", "user_annotation", 1, 10, 20),
    _x("clstm.hoist", "user_annotation", 1, 12, 6),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 13, 1, 1),
    _x("cudaLaunchKernelExC", "cuda_runtime", 1, 20, 1, 2),
    _x("clstm.backward", "user_annotation", 1, 60, 30),
    _x("cudaLaunchKernel", "cuda_runtime", 2, 65, 1, 3),
    _x("clstm.affine.bwd", "user_annotation", 2, 70, 10),
    _x("cuLaunchKernelEx", "cuda_driver", 2, 72, 1, 4),
    _x("cudaLaunchKernel", "cuda_runtime", 1, 110, 1, 5),
    _x("void gemm(float*)", "kernel", 7, 40, 5, 1),
    _x("fwd16_kernel<true>(int)", "kernel", 7, 50, 10, 2),
    _x("log_softmax_backward", "kernel", 7, 70, 4, 3),
    _x("affine_gemm_kernel<128, 2>", "kernel", 7, 80, 6, 4),
    _x("fill", "kernel", 7, 120, 3, 5),
    _x("orphan", "kernel", 7, 150, 2, 99),
    _x("late", "kernel", 7, 198, 4, 1),
]


def test_parse_puts_each_kernel_down_to_its_span():
    tr = trace.parse(PLANTED)
    assert [k[0] for k in tr["kernels"]] == [
        "gemm", "fwd16_kernel<true>", "log_softmax_backward",
        "affine_gemm_kernel<128, 2>", "fill", "orphan", "late"]
    # Nested: the innermost span on the launching thread (clstm.hoist in
    # clstm.lstm.fwd); the autograd thread's launch outside its own span
    # goes to the innermost span open on any thread (clstm.backward), the
    # one inside it to its own (clstm.affine.bwd); a launch under no
    # clstm.* span (the harness's portbench.* spans are not the
    # program's), and a kernel whose launch is not in the trace, to none.
    assert tr["kernel_spans"] == [
        "clstm.hoist", "clstm.lstm.fwd", "clstm.backward",
        "clstm.affine.bwd", None, None, "clstm.hoist"]
    # The late kernel counts its 2 us inside the window.
    assert tr["span_us"] == {"clstm.hoist": 7, "clstm.lstm.fwd": 10,
                             "clstm.backward": 4, "clstm.affine.bwd": 6}
    assert tr["unattributed_us"] == 5
    assert [s[:2] for s in tr["spans"]] == [
        ("clstm.step", 1), ("clstm.lstm.fwd", 1), ("clstm.hoist", 1),
        ("clstm.backward", 1), ("clstm.affine.bwd", 2)]
    assert tr["spans"][2][2:] == (12.0, 18.0)
    # The keys that were there before spans stay as they were.
    assert tr["window_us"] == 200 and tr["busy_us"] == 32
    assert tr["launches"] == 5 and tr["records"] == 7
    assert tr["kernels"][6] == ("late", 198.0, 2.0)
    assert set(trace.breakdown(tr)) == {"device_ops", "idle_gaps"}


def test_the_affine_reader_reads_the_spans_device_time():
    """affine_roofline_pct.train: the family's affine bound of the traced
    steps over the device ms under clstm.affine.* and clstm.hoist; nothing
    where the trace has no time there."""
    from portbench import bounds, registry
    from portbench.tests.cells import tiny_run
    run = tiny_run("bidi2.train")[0]
    read = registry.metric_reader("affine_roofline_pct.train")
    st = {"B": 8, "T": 96, "S": 21, "V": 600, "train": True}
    ctx = {"run": run, "trace": trace.parse(PLANTED), "steps": [st, st]}
    want = 2 * bounds.step_bound(run.fam, "affine")(run.cfg, st)
    assert read(ctx) == 100.0 * want / (13 * 1e-3)
    assert read({"run": run, "window": {}}) is None
    ctx["trace"] = dict(ctx["trace"], span_us={"clstm.lstm.fwd": 10})
    assert read(ctx) is None


def test_the_launch_counters_are_found_by_walking_the_ops_modules():
    """Every wrapper's counter, the affine layer's too, with no list to
    keep: a traced run records each one's growth over its stretch."""
    from portbench import program
    got = program.launch_counts()
    assert {"bidi_lstm_infer", "bidi_lstm_fwd_state", "bidi_lstm_infer_xz",
            "bidi_lstm_fwd_state_xz", "bidi_lstm_bwd_chain",
            "bidi_lstm_bwd_reduce", "ctc_forward", "ctc_both",
            "ctc_backward", "affine_fwd", "affine_bwd",
            "bidi_lstm_fwd_state.launches16"} <= set(got)
    assert all(isinstance(n, int) for n in got.values())
