"""K3 and K4 inference in the bf16 mode on the tensor cores
(csrc/bidi_lstm_fwd.cu, fwd16_kernel with EMIT=false: the C entries
clstm_bidi_lstm_fwd16 and clstm_bidi_lstm_fwd16_xz; the serving path) and
their plan, on CPU.

The kernel cannot run here, so what surrounds it is held instead, as
tests/test_torch_fwd16_plan.py does for the state mode: the no-state
shared-memory layout (csrc::geo16 without the gates and cell stage) and
the plan it gives at the serving shapes, the window where the FMA kernel
serves instead (fwd16_prefers_old, the state mode's), the route a bf16
call of bidi_lstm_infer and bidi_lstm_infer_xz takes with its launch
counts, and the torch emulation of the kernel's lane arithmetic, tile sums
and all-gather (test_torch_fwd16_plan.emulate_fwd16 with ``state=False``)
held against ops/lstm.py's plain bf16 bidi_lstm_apply and
bidi_lstm_apply_xz within EMU_RTOL of max|y| (mean within EMU_MEAN_RTOL:
both round h and y to bf16 where the JAX package does and sum in f32, in
other orders, so a sum on the other side of a bf16 rounding moves a value
by one bf16 ulp and carries down the chain, while a wrong index map moves
it by its own size), and against the JAX package's
``bidi_lstm_pallas(..., xz_bf16=True, with_state=False)`` in interpret
mode within tests/test_torch_bf16.py's envelope (Y_MAX, Y_MEAN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from test_torch_fwd16_plan import (  # noqa: E402
    EMU_CASES, EMU_MEAN_RTOL, EMU_RTOL, Y_MAX, Y_MEAN, _inputs,
    emulate_fwd16)

# (B, D, H, hoist) -> (C, rows, units, waves, bytes of shared memory) of
# the inference plan with the H100's cluster counts: the serving shapes
# (bidi's K3, bidi2's K3 at layer 1 and K4 at layer 2, at bench.py's
# infer batch and at a clstmocr bucket of 64 lines), the filter's K3 (D =
# 19, padded to 20), larger batches.
PINNED_INFER = {(256, 48, 100, False): (3, 16, 40, 1, 76032),
                (256, 48, 200, False): (3, 16, 72, 1, 186624),
                (256, 0, 200, True): (3, 16, 72, 1, 170496),
                (256, 20, 100, False): (3, 16, 40, 1, 62720),
                (64, 48, 100, False): (4, 16, 32, 1, 63744),
                (64, 48, 200, False): (4, 16, 56, 1, 149760),
                (64, 0, 200, True): (4, 16, 56, 1, 135680),
                (512, 48, 100, False): (2, 16, 56, 1, 100608),
                (1024, 0, 200, True): (3, 16, 72, 4, 170496)}


@pytest.mark.parametrize("B,D,H,hoist", sorted(PINNED_INFER))
def test_torch_fwd16_infer_plan_pinned(B, D, H, hoist):
    """At a long chain the inference plan is the cluster plan of the
    no-state instance: its shared memory is the state plan's less the gates
    and cell stage, and where the state plan fits it picks the same C, rows
    and units (the freed memory admits no plan of fewer waves or less work
    a CTA at these widths)."""
    p = bk.fwd16_plan(B, 900, D, H, hoist, state=False)
    assert p == bk.fwd16_cluster_plan(B, D, H, hoist, state=False)
    waves = -(-2 * p.groups // p.clusters)
    assert (p.C, p.rows, p.units, waves, p.smem) == PINNED_INFER[
        (B, D, H, hoist)]
    s = bk.fwd16_cluster_plan(B, D, H, hoist, state=True)
    g = bk.fwd16_geometry(D, H, s.rows, s.units, hoist, state=True)
    assert (s.C, s.rows, s.units) == (p.C, p.rows, p.units)
    assert p.smem == s.smem - g["gs"] - g["cs"]


def test_torch_fwd16_infer_smem_layout():
    """Without the state, fwd16_geometry drops the gates stage [2][R][4U +
    2] f32 and the cell stage [2][R][U] bf16 and keeps the rest as
    csrc::geo16 lays it out (the h stage still a multiple of 16 bytes:
    the hand-off copies it in 16-byte chunks); fwd16_smem counts it."""
    for D, H, R, U, hoist in ((48, 100, 16, 40, False), (0, 200, 16, 72, True),
                              (20, 7, 32, 8, False), (130, 64, 16, 8, False),
                              (48, 200, 16, 72, False)):
        g = bk.fwd16_geometry(D, H, R, U, hoist, state=False)
        s = bk.fwd16_geometry(D, H, R, U, hoist, state=True)
        KH, KX = -(-H // 16) * 16, 0 if hoist else -(-(D + 1) // 16) * 16
        assert g["gs"] == g["cs"] == 0
        assert g["bytes"] == 2 * (4 * U * (KH + KX + 8) + 2 * R * (KH + 8)
                                  + 3 * R * (4 * U if hoist else KX + 8)
                                  + 2 * R * U)
        assert g["bytes"] == s["bytes"] - s["gs"] - s["cs"]
        for part in ("bw", "ah", "ax", "hs"):
            assert g[part] == s[part] and g[part] % 16 == 0
        C = -(-H // U)
        assert bk.fwd16_smem(D, H, R, U, hoist, C, state=False) in (
            0, g["bytes"])
    # bidi2's K3 at layer 1 frees 41,728 of the state mode's 228,352 bytes.
    assert bk.fwd16_smem(48, 200, 16, 72, False, 3, state=True) - \
        bk.fwd16_smem(48, 200, 16, 72, False, 3, state=False) == 41728
    # Widths no plan holds in either mode: the FMA kernel.
    for D, H, hoist in ((402, 200, False), (6, 700, False), (0, 700, True),
                        (4, 2048, False)):
        assert bk.fwd16_plan(3, 900, D, H, hoist, state=False) == \
            bk.FWD16_NONE


# (T, H) -> whether the inference plan is the FMA kernel: the window where
# it beat the fwd16 kernel's inference instances on the card, the state
# mode's (fwd16_prefers_old, FWD16_OLD_*), and around it.
WINDOW_INFER = {(1, 100): True, (16, 100): True, (32, 100): True,
                (33, 100): False, (64, 100): False, (900, 100): False,
                (32, 40): True, (32, 101): False, (16, 101): True,
                (16, 200): True, (17, 200): False, (16, 201): False,
                (900, 200): False}


@pytest.mark.parametrize("T,H", sorted(WINDOW_INFER))
def test_torch_fwd16_infer_plan_window(T, H):
    """Inside the inference window the plan is FWD16_NONE; elsewhere the
    inference cluster plan, for K3 and K4, at B=256 and at a clstmocr
    bucket of 64 lines."""
    for B in (256, 64):
        for D, hoist in ((48, False), (0, True)):
            p = bk.fwd16_plan(B, T, D, H, hoist, state=False)
            if WINDOW_INFER[(T, H)]:
                assert p == bk.FWD16_NONE
            else:
                assert p.C and p == bk.fwd16_cluster_plan(B, D, H, hoist,
                                                          state=False)
    assert bk.fwd16_prefers_old(T, H) == WINDOW_INFER[(T, H)]


# (T, hoist, H) -> the C entry a bf16 inference call of B=3, D=6 (K3)
# launches: the fwd16 kernel past the window, the FMA kernel's bf16
# instance inside it and where no fwd16 plan fits (H = 700).
ROUTE_INFER = {(64, False, 5): "clstm_bidi_lstm_fwd16",
               (64, True, 5): "clstm_bidi_lstm_fwd16_xz",
               (4, False, 5): "clstm_bidi_lstm_fwd_bf16",
               (4, True, 5): "clstm_bidi_lstm_fwd_xz_bf16",
               (64, False, 700): "clstm_bidi_lstm_fwd_bf16",
               (64, True, 700): "clstm_bidi_lstm_fwd_xz_bf16"}


@pytest.mark.parametrize("T,hoist,H", sorted(ROUTE_INFER))
def test_torch_fwd16_infer_route_and_counts(T, hoist, H, monkeypatch):
    """bidi_lstm_infer (K3) and bidi_lstm_infer_xz (K4) in the bf16 mode
    launch the entry of the plan's kernel once a call, add one to
    ``launches`` and, on the fwd16 kernel, one to ``launches16``, with the
    plan's (C, rows, units) after the shapes; the f32 mode never takes the
    fwd16 kernel, and a Fwd16Plan forced on an f32 call raises; an empty
    batch launches and counts nothing. The wrappers run on meta tensors
    with the C entry points replaced by a recorder."""
    launched = []
    monkeypatch.setattr(bk, "_check_device", lambda device: None)
    monkeypatch.setattr(bk, "_launch",
                        lambda name, device, *args: launched.append(
                            (name, args[-3:])))
    monkeypatch.setattr(
        bk, "device_plan", lambda device, B, D, H, hoist, state, esize:
        bk.fwd_plan(B, D, H, hoist, state, esize=esize))
    monkeypatch.setattr(
        bk, "device_fwd16_plan", lambda device, B, T, D, H, hoist, *, state:
        bk.fwd16_plan(B, T, D, H, hoist, state=state))
    D = 6
    wrapper = bk.bidi_lstm_infer_xz if hoist else bk.bidi_lstm_infer
    for w in (bk.bidi_lstm_infer, bk.bidi_lstm_infer_xz):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "launches16", 0)

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")
    pf, pr = ({"Wx": m(D, 4 * H), "Wh": m(H, 4 * H), "b": m(4 * H)}
              for _ in range(2))

    def call(B, T_, bf16):
        if hoist:
            xz = m(B, T_, 2, 4 * H,
                   dtype=torch.bfloat16 if bf16 else torch.float32)
            return bk.bidi_lstm_infer_xz(pf, pr, xz, xz_bf16=bf16)
        return bk.bidi_lstm_infer(pf, pr, m(B, T_, D), hoist=False,
                                  xz_bf16=bf16)
    for B, T_ in ((0, T), (3, 0)):
        assert call(B, T_, True).shape == (B, T_, 2 * H)
    assert not launched and wrapper.launches == wrapper.launches16 == 0
    plan = bk.fwd16_plan(3, T, 0 if hoist else D, H, hoist, state=False)
    y = call(3, T, True)
    assert y.dtype == torch.bfloat16 and y.shape == (3, T, 2 * H)
    assert [n for n, _ in launched] == [ROUTE_INFER[(T, hoist, H)]]
    assert wrapper.launches == 1
    assert wrapper.launches16 == (1 if plan.C else 0)
    if plan.C:
        assert launched[0][1] == (plan.C, plan.rows, plan.units)
    call(3, T, False)
    assert launched[-1][0] == ("clstm_bidi_lstm_fwd_xz" if hoist
                               else "clstm_bidi_lstm_fwd")
    assert wrapper.launches == 2 and wrapper.launches16 == (1 if plan.C
                                                            else 0)
    if plan.C:
        with pytest.raises(ValueError):
            bk._fwd("fwd_xz" if hoist else "fwd", plan, pf, pr,
                    m(3, T, 2, 4 * H) if hoist else m(3, T, D), None, False)
    assert len(launched) == 2


@pytest.mark.parametrize("B,T,D,H,hoist,C,rows", EMU_CASES)
def test_torch_fwd16_infer_emulation_matches_plain(B, T, D, H, hoist, C,
                                                   rows):
    """The no-state emulation at the inference plan (or a forced one)
    against the plain bf16 bidi_lstm_apply / bidi_lstm_apply_xz: within
    EMU_RTOL of max|y| (mean EMU_MEAN_RTOL), exact zeros on padded frames;
    and its y bitwise the state mode's (the instances share the chain)."""
    pf, pr, x, L = _inputs(B, T, max(D, 3), H, B * 1000 + H)
    if hoist:
        inp = tlstm.hoisted_projection(pf, pr, x, xz_bf16=True)
        want = tlstm.bidi_lstm_apply_xz(pf, pr, inp, L, xz_bf16=True)
    else:
        inp = x
        want = tlstm.bidi_lstm_apply(pf, pr, x, L, xz_bf16=True)
    d = 0 if hoist else x.shape[-1] + x.shape[-1] % 2
    plan = bk.fwd16_cluster_plan(B, d, H, hoist, C=C, rows=rows,
                                 state=False)
    assert plan.C and plan.C == (C or plan.C)
    assert plan.rows == (rows or plan.rows)
    with torch.no_grad():
        got = emulate_fwd16(pf, pr, inp, L, plan, state=False)
        full = emulate_fwd16(pf, pr, inp, L, plan)
    assert len(got) == 1 and torch.equal(got[0], full[0])
    y, p = got[0], want.float()
    pad = torch.arange(T)[None, :] >= L[:, None]
    scale = float(p.abs().max())
    assert scale > 0 and bool((y[pad] == 0).all())
    err = (y - p).abs()
    assert float(err.max()) <= EMU_RTOL * scale, err.max()
    assert float(err.mean()) <= EMU_MEAN_RTOL * scale, err.mean()
    # The wrappers on CPU tensors run the plain versions.
    cpu = (bk.bidi_lstm_infer_xz(pf, pr, inp, L, xz_bf16=True) if hoist else
           bk.bidi_lstm_infer(pf, pr, x, L, hoist=False, xz_bf16=True))
    assert torch.equal(cpu, want)


@pytest.mark.parametrize("B,T,D,H", [(5, 12, 6, 24), (32, 9, 20, 40),
                                     (7, 10, 130, 40)])
def test_torch_fwd16_infer_emulation_matches_pallas_interpret(B, T, D, H):
    """The no-state emulation's y against the JAX package's serving mode,
    ``bidi_lstm_pallas(..., xz_bf16=True, with_state=False)`` (the TPU
    kernel with emit_state=False, in interpret mode), on numpy-seeded
    inputs and weights: K3 where the layer keeps the projection inside, K4
    on the bf16 hoisted product where it hoists (D = 130 > 128); max|Δy|
    within Y_MAX, mean within Y_MEAN (tests/test_torch_bf16.py's
    envelope)."""
    jnp = pytest.importorskip("jax.numpy")
    from clstm_tpu.ops.pallas_lstm import bidi_lstm_pallas

    pf, pr, x, L = _inputs(B, T, D, H, 11 * B + H)
    hoist = bk.hoists_projection(D, H)
    assert hoist == (D == 130)
    want = np.asarray(bidi_lstm_pallas(
        {k: jnp.asarray(v.numpy()) for k, v in pf.items()},
        {k: jnp.asarray(v.numpy()) for k, v in pr.items()},
        jnp.asarray(x.numpy()), jnp.asarray(L.numpy()), 8, True,
        True, with_state=False).astype(jnp.float32))
    inp = (tlstm.hoisted_projection(pf, pr, x, xz_bf16=True) if hoist
           else x)
    d = 0 if hoist else D + D % 2
    plan = bk.fwd16_cluster_plan(B, d, H, hoist, state=False)
    with torch.no_grad():
        y = emulate_fwd16(pf, pr, inp, L, plan, state=False)[0]
    diff = np.abs(y.numpy() - want)
    assert diff.max() <= Y_MAX and diff.mean() <= Y_MEAN, (diff.max(),
                                                           diff.mean())
