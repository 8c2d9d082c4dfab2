"""VGSL nets (Tesseract 4/5's line recogniser) on the port's training path:
the parser's tree at the eng widths, the port against the benchmark's
plain reference (portbench/reference/tess.py) at a tiny size, padding and
pooled lengths through the loss, the report and the decode, the
one-direction LSTM mode against the plain loop, its plans, the spans of a
training block, and the .clstm round trip. CPU, seeded."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch import train as ttrain  # noqa: E402
from clstm_tpu_torch.data.device_cache import DeviceDataset  # noqa: E402
from clstm_tpu_torch.io.proto import load_net, save_net  # noqa: E402
from clstm_tpu_torch.models import prefab  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.models.spec import (  # noqa: E402
    apply_net, frame_stride, out_lengths)
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.ops.seq import flip_within_length  # noqa: E402
from clstm_tpu_torch.utils import profiling  # noqa: E402
from portbench.reference import tess  # noqa: E402
from portbench.reference.precision import set_strict_f32  # noqa: E402

ENG = "[1,36,0,1 Ct3,3,16 Mp3,3 Lfys64 Lfx96 Lrx96 Lfx512 O1c1]"
CPU = torch.device("cpu")
# The tiny widths of the reference family (tess.tiny), 12 classes.
TINY = {"ninput": 36, "nfilters": 4, "nhidden_ysum": 5,
        "nhidden_layers": [6, 7, 8], "noutput": 12}


def _tiny_net(seed: int = 0, scale: float = 0.3):
    spec = tess.spec_of(TINY)
    return prefab.make_net_init(
        "vgsl", {"ninput": 36, "nhidden": 8, "noutput": TINY["noutput"],
                 "spec": spec, "initial": scale},
        torch.Generator().manual_seed(seed))


def _weights(net):
    """The program's parameters as the reference family's weights."""
    params = dict(net.named_parameters())
    names = tess.program_names(TINY)
    shaped = tess.make_weights(TINY, torch.Generator().manual_seed(0), 0.0,
                               "cpu")
    out = []
    for layer, w in zip(tess.NAMES, shaped):
        out.append({k: params[names[f"{layer}.{k}"]].detach().clone()
                    for k in w})
    return out


def _batch(seed: int = 1, B: int = 4, T: int = 40, lengths=(40, 31, 9, 1)):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((B, T, 36), generator=g)
    L = torch.tensor(lengths, dtype=torch.int32)
    x = x * (torch.arange(T)[None, :, None] < L[:, None, None])
    return x, L


def test_parser_builds_the_eng_tree_at_its_published_widths():
    spec = prefab.make_net("vgsl", {"ninput": 36, "nhidden": 100,
                                    "noutput": 111, "spec": ENG})
    net = prefab.make_net_init("vgsl", {"ninput": 36, "nhidden": 100,
                                        "noutput": 111, "spec": ENG})[1]
    kinds = [s.kind for s in spec.sub]
    assert kinds == ["Conv2D", "MaxPool2D", "NPLSTMYSum", "NPLSTM",
                     "Reversed", "NPLSTM", "SoftmaxLayer"]
    assert spec.sub[4].sub[0].kind == "NPLSTM"
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert shapes == {
        "sub.0.W": (9, 16), "sub.0.b": (16,),
        "sub.2.Wx": (16, 256), "sub.2.Wh": (64, 256), "sub.2.b": (256,),
        "sub.3.Wx": (64, 384), "sub.3.Wh": (96, 384), "sub.3.b": (384,),
        "sub.4.sub.0.Wx": (96, 384), "sub.4.sub.0.Wh": (96, 384),
        "sub.4.sub.0.b": (384,),
        "sub.5.Wx": (96, 2048), "sub.5.Wh": (512, 2048), "sub.5.b": (2048,),
        "sub.6.W": (512, 111), "sub.6.b": (111,)}
    assert sum(p.numel() for p in net.parameters()) == 1_461_007
    assert spec.get("vgsl") == ENG and frame_stride(spec) == 3
    cfg = json.load(open("portbench/configs/tess_eng.json"))
    assert tess.spec_of(cfg) == ENG
    assert set(tess.program_names(cfg).values()) == set(shapes)
    for bad in ("[1,48,0,1 Ct3,3,16 O1c1]", "[1,36,0,1 Lfx96 O1c1]",
                "[1,36,0,1 Ct3,3,16 Mp3,3 Lfys64 Lbxy9 O1c1]",
                "[1,36,0,1 Ct3,3,16]"):
        with pytest.raises(ValueError):
            prefab.make_net("vgsl", {"ninput": 36, "nhidden": 1,
                                     "noutput": 5, "spec": bad})


def test_the_port_matches_the_reference_at_a_tiny_size():
    """Logits, the CTC loss and every gradient of the port's f32 path (the
    plain loops, library convolution and pool) against the family's plain
    reference on the same weights and ragged lines."""
    set_strict_f32()
    spec, net = _tiny_net()
    x, L = _batch()
    w = _weights(net)
    lo = out_lengths(spec, L)
    assert lo.tolist() == [14, 11, 3, 1]
    got = apply_net(net, x, L, logits=True, xz_bf16=False)
    want = tess.logits(w, x, L)
    mask = torch.arange(got.shape[1])[None, :] < lo[:, None]
    assert got.shape == want.shape == (4, 14, 12)
    assert torch.allclose(got[mask], want[mask], atol=1e-5, rtol=0)
    # The loss and every gradient, through the port's training loss and
    # the reference's.
    from portbench.reference import train as ref_train
    texts = [[1, 2, 3], [4, 4, 5], [6], [7]]
    tg, tl = ref_train.targets_of(texts, "cpu")
    batch = {"x": x, "lengths": L, "targets": tg.int(),
             "target_lengths": tl.int()}
    loss, _ = ttrain.ctc_alignment_loss(net, batch, normalization="batch",
                                        xz_bf16=False)
    names = tess.program_names(TINY)
    params = dict(net.named_parameters())
    g_port = torch.autograd.grad(loss, [params[names[n]]
                                        for n in sorted(names)])
    ws = [{k: v.clone().requires_grad_(True) for k, v in d.items()}
          for d in w]
    ref = ref_train.loss(tess, ws, x, L, lo, tg, tl, 4)
    leaves = tess.leaves(ws)
    g_ref = torch.autograd.grad(ref, [leaves[n] for n in sorted(names)])
    assert abs(float(loss.detach()) - float(ref.detach())) <= 1e-5 * abs(
        float(ref.detach()))
    for n, a, b in zip(sorted(names), g_port, g_ref):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-3), n


@pytest.mark.parametrize("bf16", [False, True])
def test_a_line_alone_equals_the_line_padded_in_a_batch(bf16):
    """Pool masking and length-0 columns: a line's logits in a batch of
    longer lines (its padded frames, the conv's and pool's windows past
    its end, its columns past the pooled length) are its logits alone."""
    spec, net = _tiny_net(seed=3)
    x, L = _batch(seed=4, lengths=(40, 22, 17, 5))
    with torch.no_grad():
        full = apply_net(net, x, L, logits=True, xz_bf16=bf16)
        for b in range(4):
            n = int(L[b])
            alone = apply_net(net, x[b:b + 1, :n].contiguous(), L[b:b + 1],
                              logits=True, xz_bf16=bf16)
            lo = int(out_lengths(spec, n))
            assert alone.shape[1] == lo
            # bf16: the same bits; f32: the products' sums of another batch
            # size, within f32 rounding.
            assert (torch.equal(alone[0], full[b, :lo]) if bf16 else
                    torch.allclose(alone[0], full[b, :lo], atol=1e-6,
                                   rtol=0))


def test_pooled_lengths_reach_the_alignment_the_report_and_the_decode(
        monkeypatch):
    """The training step aligns over ceil(L/3) frames, its report holds the
    pooled frames, and a decode runs over them; a net that keeps T passes
    its lengths through unchanged (the same tensor)."""
    seen = []
    real = ttrain.ctc_align_targets_batched

    def spy(probs, targets, lengths, target_lengths):
        seen.append((probs.shape[1], lengths.clone()))
        return real(probs, targets, lengths=lengths,
                    target_lengths=target_lengths)
    monkeypatch.setattr(ttrain, "ctc_align_targets_batched", spy)
    rng = np.random.RandomState(0)
    samples = [(rng.rand(int(t), 36).astype(np.float32), "ab c")
               for t in (40, 34, 29, 23)]
    codec = Codec.build([t for _, t in samples])
    ocr = CLSTMOCR(target_height=36, dewarp="none", device=CPU)
    ocr.createBidi(codec, 8, kind="vgsl", spec=tess.spec_of(TINY))
    dds = DeviceDataset(samples, codec, device=CPU,
                        out_lengths=ocr.out_lengths)
    assert dds.frames_short == 0
    block = next(dds.epoch_blocks(4, 1))
    m = ocr.train_batch_block(block, k_max=1)
    T, lens = seen[0]
    assert T == -(-block["group"]["tb"] // 3)
    hl = np.asarray(block["host_lengths"][0])
    assert lens.tolist() == [-(-int(v) // 3) for v in hl]
    assert m["report_all"].shape == (1, 1 + 2 * T)
    ids, vals = ocr._predict_one(samples[0][0], (64,))
    assert len(ids) == len(vals) == 14
    L = torch.tensor([7, 5], dtype=torch.int32)
    bidi = prefab.make_net("bidi", {"ninput": 3, "nhidden": 2,
                                    "noutput": 3})
    assert out_lengths(bidi, L) is L
    short = DeviceDataset([(np.zeros((6, 36), np.float32), "abcab")],
                          codec, device=CPU, out_lengths=ocr.out_lengths)
    assert short.frames_short == 1


@pytest.mark.parametrize("reverse", [False, True])
def test_one_direction_plain_versions_match_the_plain_loop(reverse):
    """bidi_lstm_train of one direction (``params_r`` None: the forward
    with state and K2's plain chain and contractions) against autograd
    through lstm_apply (flipped within length where reversed), and the
    inference forward."""
    g = torch.Generator().manual_seed(7)
    B, T, D, H = 5, 9, 6, 7
    p = {"Wx": torch.rand((D, 4 * H), generator=g) - 0.5,
         "Wh": torch.rand((H, 4 * H), generator=g) - 0.5,
         "b": torch.rand((4 * H,), generator=g) - 0.5}
    x = torch.rand((B, T, D), generator=g)
    L = torch.tensor([9, 3, 0, 7, 1], dtype=torch.int32)
    gy = torch.rand((B, T, H), generator=g)

    def loop(pp, xx):
        if reverse:
            return flip_within_length(tlstm.lstm_apply(
                pp, flip_within_length(xx, L), L), L)
        return tlstm.lstm_apply(pp, xx, L)
    leaves = [{k: v.clone().requires_grad_(True) for k, v in p.items()}
              for _ in range(2)]
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    want = loop(leaves[0], xs[0])
    got = bk.bidi_lstm_train(leaves[1], None, xs[1], L, reverse=reverse)
    assert torch.allclose(got, want, atol=1e-6)
    gw = torch.autograd.grad((want * gy).sum(), [xs[0], *leaves[0].values()])
    gg = torch.autograd.grad((got * gy).sum(), [xs[1], *leaves[1].values()])
    for a, b in zip(gg, gw):
        assert torch.allclose(a, b, atol=1e-5)
    with torch.no_grad():
        assert torch.allclose(bk.bidi_lstm_infer(p, None, x, L,
                                                 reverse=reverse),
                              want, atol=1e-6)
        assert torch.allclose(bk.bidi_lstm_infer(p, None, x, L, hoist=True,
                                                 reverse=reverse),
                              want, atol=1e-6)


@pytest.mark.parametrize("reverse", [False, True])
def test_one_direction_launches_its_entries_and_counts(reverse, monkeypatch):
    """A lone layer in the bf16 mode launches each kernel's C entry in its
    mode (the forward's hoist and emit, the bf16 flag) with its directions
    last (1 forward, 2 reversed), one direction's streams out, and adds one
    to each wrapper's ``launches`` and ``launches1``; the bidi pair takes
    the same entry with directions 0 and leaves ``launches1`` alone; one
    direction in
    strict f32 raises (a lone layer then runs lstm_apply: one_direction
    holds in the bf16 mode only). The wrappers run on meta tensors with the
    C entry points replaced by a recorder, the plans at an H100's."""
    launched = []
    monkeypatch.setattr(bk, "_check_device", lambda device: None)
    monkeypatch.setattr(bk, "_launch", lambda name, device, *args:
                        launched.append((name, args)))
    monkeypatch.setattr(bk, "_kernel", lambda name: lambda *args: 16)
    monkeypatch.setattr(
        bk, "device_plan", lambda device, B, D, H, hoist, state, esize,
        ndir: bk.fwd_plan(B, D, H, hoist, state, esize=esize, ndir=ndir))
    monkeypatch.setattr(
        bk, "device_fwd16_plan", lambda device, B, T, D, H, hoist, *, state,
        ndir: bk.fwd16_plan(B, T, D, H, hoist, state=state, ndir=ndir))
    monkeypatch.setattr(bk, "device_chain_plan", lambda device, B, T, H,
                        ndir: bk.chain_plan(B, T, H, ndir=ndir))
    monkeypatch.setattr(bk, "device_reduce_plan", lambda device, B, T, D, H,
                        ndir: bk.reduce_plan(B, T, D, H, ndir=ndir))
    wrappers = (bk.bidi_lstm_infer, bk.bidi_lstm_fwd_state,
                bk.bidi_lstm_infer_xz, bk.bidi_lstm_fwd_state_xz,
                bk.bidi_lstm_bwd_chain, bk.bidi_lstm_bwd_reduce)
    for w in wrappers:
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches1", 0)
        if hasattr(w, "launches16"):
            monkeypatch.setattr(w, "launches16", 0)
    B, T, D, H = 3, 5, 6, 8
    dm = 2 if reverse else 1
    bf = torch.bfloat16

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    p = {"Wx": m(D, 4 * H), "Wh": m(H, 4 * H), "b": m(4 * H)}
    x = m(B, T, D)
    y, gates, cell = bk.bidi_lstm_fwd_state(p, None, x, xz_bf16=True,
                                            reverse=reverse)
    assert (y.shape, gates.shape, cell.shape) == (
        (B, T, H), (B, T, 1, 4 * H), (B, T, 1, H))
    assert bk.bidi_lstm_infer(p, None, x, hoist=False, xz_bf16=True,
                              reverse=reverse).shape == (B, T, H)
    xz = m(B, T, 1, 4 * H, dtype=bf)
    assert bk.bidi_lstm_infer_xz(p, None, xz, xz_bf16=True,
                                 reverse=reverse).shape == (B, T, H)
    assert bk.bidi_lstm_fwd_state_xz(p, None, xz, xz_bf16=True,
                                     reverse=reverse)[1].shape == gates.shape
    dz = bk.bidi_lstm_bwd_chain(gates, cell, m(B, T, H, dtype=bf),
                                m(1, H, 4 * H), xz_bf16=True, reverse=reverse)
    assert dz.shape == (B, T, 1, 4 * H)
    dW, dx = bk.bidi_lstm_bwd_reduce(x, y, dz, m(1, D, 4 * H), True,
                                     xz_bf16=True, reverse=reverse)
    assert dW.shape == (1, D + 1 + H, 4 * H) and dx.shape == x.shape
    # At B=3, T=5 the forward plans are the FMA kernel's
    # (fwd16_prefers_old) and the chain's a cluster plan: each entry with its
    # trailing mode arguments, (hoist, emit, bf, dm) for the forward.
    want = [("clstm_lstm_fwd", (0, 1, 1, dm)),
            ("clstm_lstm_fwd", (0, 0, 1, dm)),
            ("clstm_lstm_fwd", (1, 0, 1, dm)),
            ("clstm_lstm_fwd", (1, 1, 1, dm)),
            ("clstm_lstm_bwd_chain16", (dm,)),
            ("clstm_lstm_bwd_reduce_bf16", (dm,))]
    assert len(launched) == 6
    assert [(n, a[len(a) - len(m):])
            for (n, a), (_, m) in zip(launched, want)] == want
    for w in wrappers:
        assert w.launches == w.launches1 == 1, w.__name__
    bk.bidi_lstm_fwd_state(p, p, x, xz_bf16=True)
    assert (launched[-1][0], launched[-1][1][-4:]) == ("clstm_lstm_fwd",
                                                      (0, 1, 1, 0))
    assert bk.bidi_lstm_fwd_state.launches == 2
    assert bk.bidi_lstm_fwd_state.launches1 == 1
    with pytest.raises(ValueError):
        bk.bidi_lstm_fwd_state(p, None, x, reverse=reverse)
    with pytest.raises(ValueError):
        bk.bidi_lstm_bwd_chain(m(B, T, 1, 4 * H), m(B, T, 1, H), m(B, T, H),
                               m(1, H, 4 * H), reverse=reverse)
    with pytest.raises(ValueError):
        bk.bidi_lstm_bwd_reduce(x, m(B, T, H), m(B, T, 1, 4 * H),
                                m(1, D, 4 * H), reverse=reverse)
    assert len(launched) == 7
    from clstm_tpu_torch.models.spec import ApplyCtx, one_direction
    c = torch.zeros(1)
    assert one_direction(ApplyCtx(xz_bf16=True), c)
    assert not one_direction(ApplyCtx(xz_bf16=False), c)
    assert not one_direction(ApplyCtx(xz_bf16=True, fuse_bidi=False), c)
    assert not one_direction(ApplyCtx(compute_dtype=torch.bfloat16), c)


@pytest.mark.parametrize("B,T,D,H", [(131072, 12, 16, 64),
                                     (256, 512, 64, 96), (256, 512, 96, 96),
                                     (256, 512, 96, 512), (256, 512, 48, 100)])
def test_one_direction_plans_count_one_directions_groups(B, T, D, H):
    """At the eng net's shapes (and bidi's), every plan of a lone layer
    counts one direction's row groups where the bidi pair's counts two:
    no more waves than the pair's, its rows as the pair's would be at
    twice the clusters; at H=512 the forward takes a cluster of 16 CTAs
    (FWD16_WIDE_C: no portable size holds its slice) and K2's chain its L2
    plan (CHAIN_L2), in either mode."""
    one = bk.fwd16_plan(B, T, D, H, False, state=True, ndir=1)
    two = bk.fwd16_plan(B, T, D, H, False, state=True)
    for p, n in ((one, 1), (two, 2)):
        if p.C:
            assert p.groups == -(-B // p.rows)
    if two.C:
        assert one.C and -(-one.groups // one.clusters) <= -(
            -2 * two.groups // two.clusters)
    f1 = bk.fwd_plan(B, D, H, False, True, esize=2, ndir=1)
    f2 = bk.fwd_plan(B, D, H, False, True, esize=2)
    assert -(-f1.groups // f1.clusters) <= -(-2 * f2.groups // f2.clusters)
    c1, c2 = bk.chain_plan(B, T, H, ndir=1), bk.chain_plan(B, T, H)
    if c2.C:
        assert -(-c1.groups // c1.clusters) <= -(
            -2 * c2.groups // c2.clusters)
        # The pair's plan where one direction's groups fit its one wave.
        assert c1 == c2 or c2.groups > c2.clusters
    r1, r2 = bk.reduce_plan(B, T, D, H, ndir=1), bk.reduce_plan(B, T, D, H)
    assert r1.scratch < r2.scratch
    assert r1.blocks // r1.ranges * 2 == r2.blocks // r2.ranges
    if H == 512:
        assert one.C == two.C == bk.FWD16_WIDE_C
        assert c1 == c2 == bk.CHAIN_L2
        assert f1.resident == 0
    if (B, T) == (131072, 12):
        assert not one.C and f1.groups == f2.groups == -(-B // f1.rows)
    assert bk.fwd16_plan(B, T, D, H, False, state=True) == two


def test_a_block_emits_the_conv_and_column_lstm_spans(tmp_path):
    """A train_batch_block of a tiny eng-shaped net under profiling.trace,
    in the bf16 mode (the one-direction kernels' route): clstm.conv.* and
    clstm.ysum.* in the step and its backward, the x-LSTMs' clstm.lstm.*,
    and no clstm.lstm.* span inside a clstm.ysum.* one."""
    rng = np.random.RandomState(1)
    samples = [(rng.rand(int(t), 36).astype(np.float32), "ab c")
               for t in (30, 27, 24, 21)]
    codec = Codec.build([t for _, t in samples])
    ocr = CLSTMOCR(target_height=36, dewarp="none", device=CPU)
    ocr.createBidi(codec, 8, kind="vgsl", spec=tess.spec_of(TINY))
    ocr.xz_bf16 = True
    dds = DeviceDataset(samples, codec, device=CPU)
    with profiling.trace(str(tmp_path)) as prof:
        ocr.train_batch_block(next(dds.epoch_blocks(4, 1)), k_max=1)
    with open(prof.trace_path) as f:
        spans = profiling.span_account(json.load(f)["traceEvents"])["spans"]
    names = [n for n, *_ in spans]

    def inside(outer):
        return {n for n, _, s, e in spans for o, _, s2, e2 in spans
                if o == outer and s2 <= s and e <= e2 and n != outer}
    for n in ("clstm.conv.fwd", "clstm.conv.bwd", "clstm.ysum.fwd",
              "clstm.ysum.bwd"):
        assert n in names
    assert names.count("clstm.lstm.fwd") == 3    # Lfx, Lrx, Lfx
    assert names.count("clstm.lstm.bwd") == 3
    for n in ("clstm.ysum.fwd", "clstm.ysum.bwd"):
        assert not {s for s in inside(n) if s.startswith("clstm.lstm")}


def test_a_saved_vgsl_net_loads_with_the_same_logits(tmp_path, monkeypatch):
    """The .clstm round trip of a VGSL net (io/proto.py), and
    clstmocrtrain building one from its ``vgsl`` setting."""
    spec, net = _tiny_net(seed=5)
    x, L = _batch(seed=6)
    path = str(tmp_path / "tess.clstm")
    save_net(path, net)
    spec2, net2, _, _ = load_net(path)
    assert spec2 == spec
    with torch.no_grad():
        assert torch.equal(apply_net(net, x, L, logits=True),
                           apply_net(net2, x, L, logits=True))
    from clstm_tpu_torch.cli import clstmocrtrain
    built = {}

    def fake_train(ocr, codec, **kw):
        built["spec"] = ocr.spec
        return 0
    monkeypatch.setattr(clstmocrtrain, "train", fake_train)
    rng = np.random.RandomState(2)
    from clstm_tpu_torch.io.png import write_png
    files = []
    for i in range(3):
        img = (rng.rand(36, 60) > 0.5).astype(np.float32)
        f = str(tmp_path / f"l{i}.png")
        write_png(f, img)
        with open(f[:-4] + ".gt.txt", "w") as fh:
            fh.write("ab")
        files.append(f)
    manifest = tmp_path / "train.files"
    manifest.write_text("\n".join(files) + "\n")
    for k, v in {"device": "cpu", "target_height": "36", "dewarp": "none",
                 "vgsl": tess.spec_of(TINY), "ntrain": "1"}.items():
        monkeypatch.setenv(k, v)
    clstmocrtrain.main([str(manifest)])
    assert built["spec"].get("vgsl") == tess.spec_of(TINY)
    assert [s.kind for s in built["spec"].sub][:3] == [
        "Conv2D", "MaxPool2D", "NPLSTMYSum"]
