"""The port's CTC alignment against the JAX package, on CPU.

K5 and K6 (the forward DP and the fused second direction) run here as
their plain versions — the kernels' wrappers take them for CPU tensors —
and are held against the TPU kernels they replace, ``ctc_forward_pallas``
and ``ctc_both_pallas`` in interpret mode (S=128, B=8, the TPU layout), and
against the JAX scan recipe. Inputs come from numpy, padded rows have
different frame and target lengths, and only valid entries (t < len,
s < tlen) are compared: padded entries are free in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from clstm_tpu.ops import ctc as jctc  # noqa: E402
from clstm_tpu.ops.pallas_ctc import (  # noqa: E402
    ctc_both_pallas, ctc_forward_pallas)
from clstm_tpu_torch.ops import ctc as tctc  # noqa: E402
from clstm_tpu_torch.ops.ctc_kernel import ctc_both, ctc_forward  # noqa: E402

# f32 DP values reach ~-300 here; the two packages' logaddexp agree to a
# few ulp per step, so 1e-5 relative holds the whole lattice (the JAX
# package's own kernel-vs-scan tolerance).
DP_RTOL, DP_ATOL = 1e-5, 1e-5
# Aligned targets are probabilities in [1e-5, 1]: 1e-5 absolute is below
# the LO floor, far below any training-relevant change (the TPU precision
# fault moved them by ~4e-3).
ALIGN_ATOL = 1e-5


def _lattice(B, T, S, seed):
    """lmatch [B, T, S] with invalid states NEG, and the row lengths."""
    rng = np.random.RandomState(seed)
    lmatch = np.log(rng.rand(B, T, S).astype(np.float32) + 1e-3)
    tlens = rng.randint(1, min(S, 40) + 1, size=B).astype(np.int32)
    lengths = rng.randint(0, T + 1, size=B).astype(np.int32)
    lengths[0], lengths[1] = T, 0
    for b in range(B):
        lmatch[b, :, tlens[b]:] = jctc.NEG
    return lmatch, lengths, tlens


def _assert_valid_close(got, want, lengths, tlens):
    for b in range(got.shape[0]):
        L, S = lengths[b], tlens[b]
        np.testing.assert_allclose(got[b, :L, :S], want[b, :L, :S],
                                   rtol=DP_RTOL, atol=DP_ATOL,
                                   err_msg=f"row {b}")


def test_torch_mktargets_match_jax():
    for classes in ([], [3], [1, 2, 2, 5]):
        np.testing.assert_array_equal(tctc.mktargets_ids(classes),
                                      jctc.mktargets_ids(classes))
        np.testing.assert_array_equal(tctc.mktargets(classes, 6),
                                      jctc.mktargets(classes, 6))
        for S in (3, 16):
            np.testing.assert_array_equal(tctc.mktargets_ids(classes, S),
                                          jctc.mktargets_ids(classes, S))


def test_torch_forward_scan_and_backward_dp_match_jax():
    lmatch, lengths, tlens = _lattice(6, 24, 17, seed=0)
    tvalid = np.arange(24)[None, :] < lengths[:, None]
    lr = tctc._forward_scan(torch.from_numpy(lmatch), torch.from_numpy(tvalid),
                            -5.0).numpy()
    want = np.asarray(jctc._forward_scan(jnp.asarray(lmatch),
                                         jnp.asarray(tvalid), -5.0))
    np.testing.assert_allclose(lr, want, rtol=DP_RTOL, atol=DP_ATOL)
    rl = tctc._backward_dp(torch.from_numpy(lmatch), torch.from_numpy(tvalid),
                           torch.from_numpy(lengths), torch.from_numpy(tlens),
                           -5.0).numpy()
    want = np.asarray(jctc._backward_dp(
        jnp.asarray(lmatch), jnp.asarray(tvalid), jnp.asarray(lengths),
        jnp.asarray(tlens), -5.0, False))
    _assert_valid_close(rl, want, lengths, tlens)
    one = tctc.forward_algorithm(torch.from_numpy(lmatch[0])).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jctc.forward_algorithm(jnp.asarray(lmatch[0]))),
        rtol=DP_RTOL, atol=DP_ATOL)


def test_torch_ctc_kernels_plain_match_pallas_interpret():
    """K5 and K6 against the TPU kernels, at the TPU's layout (S=128)."""
    lmatch, lengths, tlens = _lattice(8, 32, 128, seed=1)
    lm, L, TL = (torch.from_numpy(a) for a in (lmatch, lengths, tlens))
    lr = ctc_forward(lm, L)
    want_lr = np.asarray(ctc_forward_pallas(jnp.asarray(lmatch),
                                            jnp.asarray(lengths),
                                            interpret=True))
    _assert_valid_close(lr.numpy(), want_lr, lengths, tlens)
    both, lse = ctc_both(lm, lr, L, TL)
    want_both, want_lse = ctc_both_pallas(
        jnp.asarray(lmatch), jnp.asarray(want_lr), jnp.asarray(lengths),
        jnp.asarray(tlens), interpret=True)
    _assert_valid_close(both.numpy(), np.asarray(want_both), lengths, tlens)
    want_lse = np.asarray(want_lse)
    for b in range(8):
        if lengths[b]:
            np.testing.assert_allclose(lse[b, :tlens[b]].numpy(),
                                       want_lse[b, :tlens[b]],
                                       rtol=DP_RTOL, atol=DP_ATOL)
        # Frames t >= len are NEG in both.
        assert (both[b, lengths[b]:].numpy() == jctc.NEG).all()
    # The plain K5 carries the state through padded frames, as the scan does.
    tvalid = torch.arange(32)[None, :] < L[:, None]
    np.testing.assert_array_equal(
        lr.numpy(), tctc._forward_scan(lm, tvalid, -5.0).numpy())


def _align_inputs(B, T, C, S, seed):
    rng = np.random.RandomState(seed)
    probs = rng.dirichlet(np.ones(C), size=(B, T)).astype(np.float32)
    lengths = rng.randint(1, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    lengths[-1] = 0
    tids = np.zeros((B, S), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(0, (S - 1) // 2 + 1)
        ids = jctc.mktargets_ids(rng.randint(1, C, size=n))
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    return probs, tids, lengths, tlens


@pytest.mark.parametrize("fused", [True, False])
def test_torch_align_targets_match_jax_scan_recipe(fused):
    probs, tids, lengths, tlens = _align_inputs(6, 30, 7, 13, seed=2)
    got = tctc.ctc_align_targets_batched(
        torch.from_numpy(probs), torch.from_numpy(tids),
        lengths=torch.from_numpy(lengths),
        target_lengths=torch.from_numpy(tlens), fused=fused).numpy()
    want = np.asarray(jctc.ctc_align_targets_batched(
        jnp.asarray(probs), jnp.asarray(tids), lengths=jnp.asarray(lengths),
        target_lengths=jnp.asarray(tlens), use_pallas=False))
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(got[b, :L], want[b, :L], rtol=0,
                                   atol=ALIGN_ATOL, err_msg=f"row {b}")
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


def test_torch_align_fused_matches_pallas_epath():
    """The fused epath exp(both - lse) from the port's K5/K6 equals the one
    the TPU kernels give on the same lmatch."""
    lmatch, lengths, tlens = _lattice(8, 32, 128, seed=3)
    lm, L, TL = (torch.from_numpy(a) for a in (lmatch, lengths, tlens))
    both, lse = ctc_both(lm, ctc_forward(lm, L), L, TL)
    got = torch.where(both > 0.5 * tctc.NEG, torch.exp(both - lse[:, None]),
                      torch.zeros(())).numpy()
    lr = ctc_forward_pallas(jnp.asarray(lmatch), jnp.asarray(lengths),
                            interpret=True)
    jb, jl = ctc_both_pallas(jnp.asarray(lmatch), lr, jnp.asarray(lengths),
                             jnp.asarray(tlens), interpret=True)
    want = np.where(np.asarray(jb) > 0.5 * jctc.NEG,
                    np.exp(np.asarray(jb) - np.asarray(jl)[:, None]), 0.0)
    for b, Lb in enumerate(lengths):
        np.testing.assert_allclose(got[b, :Lb, :tlens[b]],
                                   want[b, :Lb, :tlens[b]],
                                   rtol=2e-4, atol=1e-6)


def test_torch_align_float64_scan_agrees_with_fused_f32():
    probs, tids, lengths, tlens = _align_inputs(5, 40, 9, 15, seed=4)
    args = dict(lengths=torch.from_numpy(lengths),
                target_lengths=torch.from_numpy(tlens))
    f32 = tctc.ctc_align_targets_batched(
        torch.from_numpy(probs), torch.from_numpy(tids), **args)
    f64 = tctc.ctc_align_targets_batched(
        torch.from_numpy(probs).double(), torch.from_numpy(tids),
        fused=False, **args)
    assert f32.dtype == torch.float32 and f64.dtype == torch.float64
    for b, L in enumerate(lengths):
        np.testing.assert_allclose(f32[b, :L].numpy(), f64[b, :L].numpy(),
                                   rtol=0, atol=ALIGN_ATOL)


def test_torch_align_single_example_matches_jax():
    rng = np.random.RandomState(5)
    probs = rng.dirichlet(np.ones(5), size=20).astype(np.float32)
    targets = jctc.mktargets([1, 3, 3, 2], 5)
    got = tctc.ctc_align_targets(torch.from_numpy(probs),
                                 torch.from_numpy(targets)).numpy()
    want = np.asarray(jctc.ctc_align_targets(jnp.asarray(probs),
                                             jnp.asarray(targets)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ALIGN_ATOL)


def _bad_ctc_inputs():
    lmatch, lengths, tlens = _lattice(3, 5, 4, seed=6)
    lm, L, TL = (torch.from_numpy(a) for a in (lmatch, lengths, tlens))
    return {
        "lmatch_float64": (lm.double(), L, TL),
        "lmatch_2d": (lm[0], L, TL),
        "lmatch_noncontiguous": (lm.transpose(1, 2).contiguous()
                                 .transpose(1, 2), L, TL),
        "lengths_int64": (lm, L.long(), TL),
        "lengths_wrong_size": (lm, L[:2], TL),
        "target_lengths_int64": (lm, L, TL.long()),
    }


@pytest.mark.parametrize("case", sorted(_bad_ctc_inputs()))
def test_torch_ctc_wrappers_reject(case):
    lm, L, TL = _bad_ctc_inputs()[case]
    before = (ctc_forward.launches, ctc_both.launches)
    with pytest.raises(ValueError):
        if case.startswith("target"):
            ctc_both(lm, lm, L, TL)
        else:
            ctc_forward(lm, L)
            ctc_both(lm, lm, L, TL)
    with pytest.raises(ValueError):
        ctc_both(lm, lm[:, :-1], L, TL)          # lr of another shape
    assert (ctc_forward.launches, ctc_both.launches) == before


def test_torch_ctc_wrappers_cpu_count_no_launch():
    lmatch, lengths, tlens = _lattice(3, 5, 4, seed=7)
    lm, L, TL = (torch.from_numpy(a) for a in (lmatch, lengths, tlens))
    before = (ctc_forward.launches, ctc_both.launches)
    ctc_both(lm, ctc_forward(lm, L), L, TL)
    assert (ctc_forward.launches, ctc_both.launches) == before
