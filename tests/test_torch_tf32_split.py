"""The precision argument behind K2's reduction kernel, emulated on CPU.

On the card, csrc/bidi_lstm_bwd.cu computes dW = Σ_frames [x|1|h_prev]ᵀ·dz
and dx = dz·Wxᵀ on the tensor cores, which take TF32 (a 10-bit mantissa).
Each f32 operand is split v = hi + lo, both TF32 (``cvt.rna``: round to
nearest, ties away from zero), and the product is taken as lo·hi + hi·lo +
hi·hi ("3xTF32"). These tests round on the f32 bits as the card does and
show, at a small reduction shape, that 3 passes land within the float64
guard that chip_smoke.py applies on the card (F64_FACTOR times the plain
f32 einsum's distance, or F64_FLOOR), and that one TF32 pass does not.
TF32 products are exact in f32 (11 x 11 significant bits), so the passes
are emulated as float64 products of the rounded operands.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import F64_FACTOR, F64_FLOOR  # noqa: E402
from clstm_tpu_torch.ops.lstm import bidi_lstm_bwd_reduce_plain  # noqa: E402


def to_tf32(v: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (ties away from zero), as f32: add half
    of the 13 dropped bits' range to the magnitude bits, then clear them."""
    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(v: np.ndarray):
    hi = to_tf32(v)
    return hi, to_tf32(v - hi)


def product(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a @ b with both operands in TF32: one pass (hi·hi) or three
    (lo·hi + hi·lo + hi·hi), each pass exact, summed in float64."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)

    def mm(u, v):
        return u.astype(np.float64) @ v.astype(np.float64)
    if passes == 1:
        return mm(ah, bh)
    return mm(al, bh) + mm(ah, bl) + mm(ah, bh)


def _reduction(B, T, D, H, seed):
    """Operands of K2's reduction, as K1 and the chain would give them."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (B, T, D)).astype(np.float32)
    y = np.tanh(rng.normal(size=(B, T, 2 * H))).astype(np.float32)
    dz = (rng.normal(size=(B, T, 2, 4 * H)) * 0.1).astype(np.float32)
    wx = rng.uniform(-0.3, 0.3, (2, D, 4 * H)).astype(np.float32)
    return x, y, dz, wx


def _a_operand(x, y):
    """[2, B·T, D+1+H]: [x | 1 | h_prev] per direction (h_prev is y one
    frame back in chain order, 0 at the chain's first frame)."""
    B, T, D = x.shape
    H = y.shape[-1] // 2
    hf = np.concatenate([np.zeros((B, 1, H), np.float32), y[:, :-1, :H]], 1)
    hr = np.concatenate([y[:, 1:, H:], np.zeros((B, 1, H), np.float32)], 1)
    xc = np.concatenate([x, np.ones((B, T, 1), np.float32)], -1)
    return np.stack([np.concatenate([xc, h], -1).reshape(B * T, -1)
                     for h in (hf, hr)])


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("B,T,D,H", [(4, 256, 48, 25), (2, 300, 1, 1)])
def test_torch_3xtf32_within_float64_guard_one_pass_not(B, T, D, H):
    x, y, dz, wx = _reduction(B, T, D, H, seed=B + D)
    a = _a_operand(x, y)                                 # [2, N, M]
    z = dz.transpose(2, 0, 1, 3).reshape(2, B * T, 4 * H)  # [2, N, 4H]
    dw64 = np.einsum("gnm,gnj->gmj", a.astype(np.float64),
                     z.astype(np.float64))
    zc = dz.reshape(B * T, 8 * H)                        # [N, 2·4H]
    wcat = wx.transpose(0, 2, 1).reshape(8 * H, D)       # [2·4H, D]
    dx64 = zc.astype(np.float64) @ wcat.astype(np.float64)
    dw_p, dx_p = bidi_lstm_bwd_reduce_plain(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(dz),
        torch.from_numpy(wx), True)
    # The port's plain f32 reduction is the reference's own layout.
    np.testing.assert_allclose(dw_p.numpy(), dw64, rtol=1e-4, atol=1e-4)
    for name, ref, plain, got in (
            ("dW", dw64, dw_p.numpy(),
             lambda p: np.stack([product(a[g].T, z[g], p) for g in (0, 1)])),
            ("dx", dx64, dx_p.numpy().reshape(B * T, D),
             lambda p: product(zc, wcat, p))):
        guard = max(F64_FACTOR * _rel(plain, ref), F64_FLOOR)
        three = _rel(got(3).astype(np.float32), ref)
        one = _rel(got(1).astype(np.float32), ref)
        assert three <= guard, (name, three, guard)
        assert one > 10 * guard, (name, one, guard)


def test_torch_tf32_rounding_matches_cvt_rna():
    """hi keeps 11 significant bits, rounds to nearest with ties away from
    zero, and hi + lo recovers v to within 2^-21 of |v|."""
    v = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                  -(1 + 2.0 ** -11), 3.14159265, -2.5e-8], np.float32)
    hi = to_tf32(v)
    np.testing.assert_array_equal(
        hi[:4], np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9,
                          -(1 + 2.0 ** -10)], np.float32))
    assert (hi.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    rng = np.random.RandomState(0)
    w = (rng.normal(size=10000) * 10.0 ** rng.uniform(-6, 6, 10000)).astype(
        np.float32)
    h, lo = split_tf32(w)
    assert (np.abs(h.astype(np.float64) - w) <= 2.0 ** -11 * np.abs(w)).all()
    assert (np.abs(h.astype(np.float64) + lo - w)
            <= 2.0 ** -21 * np.abs(w)).all()
