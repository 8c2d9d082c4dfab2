"""K2's bf16 reduction: its plan, frame split and staging
(ops/bidi_lstm_kernel.py::reduce_plan, csrc/bidi_lstm_bwd.cu), on CPU.

The kernel cannot run here, so what surrounds it is held here instead: the
plan at the four shapes the port times it at (the filter's, bidi's and
bidi2's two layers), and at chip_smoke.py's odd shapes that its slices and
frame ranges cover every frame exactly once, that the dW blocks fill the
card wherever there is work enough, and that the scratch holds the layout
the C side lays out; the staged [x | 1 | 0..] copy, whose plain reduction
must equal that of x bit for bit.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402

# (B, T, D, H) -> (nw, tt, spr, ranges, blocks, nwd) on an H100 (132 SMs):
# the filter path (D=19: 18 symbols and the blank, H=100, inputs of <= 32
# frames), bidi (B=256, T=1024, D=48, H=100), bidi2's first layer (D=48,
# H=200) and its second (D=400).
PINNED = {(256, 32, 19, 100): (200, 32, 8, 16, 128, 64),
          (256, 1024, 48, 100): (200, 64, 256, 16, 128, 64),
          (256, 1024, 48, 200): (200, 64, 373, 11, 264, 64),
          (256, 1024, 400, 200): (200, 64, 373, 11, 528, 200)}
# chip_smoke.py's BF16_ODD and ODD_SHAPES, and the filter's shape.
SHAPES = [(1, 5, 5, 7), (3, 1, 48, 100), (17, 5, 49, 201), (3, 5, 130, 7),
          (17, 1, 401, 200), (3, 5, 5, 700), (2, 5, 3, 2048),
          (5, 37, 3, 7), (3, 20, 49, 300), (9, 64, 48, 100), (2, 9, 1, 1),
          (256, 32, 19, 100)]


def _up(v, m):
    return -(-v // m) * m


@pytest.mark.parametrize("shape", sorted(PINNED), ids=str)
def test_torch_reduce_plan_pinned(shape):
    """The plan at the timed shapes: tiles of 200 gate columns (4H = 400
    and 800 split evenly), slices of T's 32 or 64 frames, and frame ranges
    that fill whole waves of the 132 SMs (one at the filter's shape and
    bidi, two and four at bidi2's layers)."""
    p = bk.reduce_plan(*shape)
    assert (p.nw, p.tt, p.spr, p.ranges, p.blocks, p.nwd) == PINNED[shape]


def _slices(plan, B, T):
    """Each frame range's frames (b, t), by the kernel's map: slice g of
    range r (g in [r·spr, (r+1)·spr)) is rows [b0, b0 + bb) and frames
    [t0, t0 + tt) with b0 = (g // ntb)·bb, t0 = (g % ntb)·tt."""
    bb = bk.RED_SLICE // plan.tt
    ntb = -(-T // plan.tt)
    S = bk.reduce_slices(B, T, plan.tt)
    out = []
    for r in range(plan.ranges):
        frames = []
        for g in range(r * plan.spr, min(S, (r + 1) * plan.spr)):
            b0, t0 = (g // ntb) * bb, (g % ntb) * plan.tt
            frames += [(b, t) for b in range(b0, min(B, b0 + bb))
                       for t in range(t0, min(T, t0 + plan.tt))]
        out.append(frames)
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_torch_reduce_plan_covers_and_fits(shape):
    """Every frame lies in exactly one range and no range is empty; a
    slice is 64 frames; the dW blocks are the row-tile pairs times the
    column tiles times two directions times the ranges and, wherever there
    are RED_FILL + 1 slices of work per SM, occupy 95% of the SMs or more;
    the scratch is the C side's layout."""
    B, T, D, H = shape
    p = bk.reduce_plan(*shape)
    assert p.tt & (p.tt - 1) == 0 and p.tt <= bk.RED_SLICE
    assert p.tt >= min(T, bk.RED_SLICE)
    ranges = _slices(p, B, T)
    assert all(ranges)
    seen = list(itertools.chain.from_iterable(ranges))
    assert len(seen) == len(set(seen)) == B * T
    G = 4 * H
    row_tiles = _up(D + 1, 64) // 64 + _up(H, 64) // 64
    tiles = 2 * _up(row_tiles, 2) // 2 * _up(G, p.nw) // p.nw
    assert p.blocks == tiles * p.ranges
    S = bk.reduce_slices(B, T, p.tt)
    if tiles * S >= bk.H100_SMS * (bk.RED_FILL + 1):
        assert min(p.blocks, bk.H100_SMS) >= 0.95 * bk.H100_SMS
    assert p.nw in bk.RED_WIDTHS and p.nwd in bk.RED_WIDTHS
    assert _up(G, p.nw) - G < p.nw and _up(D, p.nwd) - D < p.nwd
    # The layout of csrc::red16: staged x and y (whole 64-column tiles),
    # staged dz (H odd), staged wx, the partials (more than one range);
    # each 256-byte aligned.
    N, M = B * T, D + 1 + H
    want = _up(2 * N * _up(D + 1, 64), 256) + _up(2 * N * 2 * _up(H, 64), 256)
    if H % 2:
        want += _up(2 * N * 2 * _up(G, 8), 256)
    want += _up(2 * 2 * D * _up(G, 64), 256)
    if p.ranges > 1:
        want += 4 * p.ranges * 2 * M * G
        assert 4 * p.ranges * 2 * M * G <= bk.RED_PARTIALS_MAX
    assert p.scratch == want


def test_torch_reduce_plan_tile_widths():
    """The tile width: the fewest columns computed, then the widest."""
    assert [bk.tile_width(n) for n in (4, 28, 64, 65, 400, 800, 804, 2800,
                                       8192, 19, 130, 401)] == [
        64, 64, 64, 128, 200, 200, 64, 200, 128, 64, 64, 64]


def test_torch_reduce_plan_device():
    """Away from a card the plan takes an H100's SMs; fewer SMs take more
    waves, never a different cover."""
    cpu = bk.device_reduce_plan(torch.device("cpu"), 256, 32, 19, 100)
    assert cpu == bk.reduce_plan(256, 32, 19, 100, bk.H100_SMS)
    small = bk.reduce_plan(256, 32, 19, 100, 16)
    assert small.nw == cpu.nw and small.tt == cpu.tt
    seen = list(itertools.chain.from_iterable(_slices(small, 256, 32)))
    assert sorted(seen) == [(b, t) for b in range(256) for t in range(32)]
    with pytest.raises(ValueError):
        bk.reduce_plan(0, 32, 19, 100)


@pytest.mark.parametrize("D,dtype", list(itertools.product(
    (1, 3, 5, 19, 48, 49), (torch.float32, torch.bfloat16))),
    ids=lambda v: str(v).replace("torch.", ""))
def test_torch_reduce_staged_x(D, dtype):
    """The staged copy [x | 1 | 0..]: bf16, roundup(D+1, 64) columns, x
    rounded to bf16, the ones in column D, zeros past it; the plain bf16
    reduction of its x columns equals that of x bit for bit (dW, and dx in
    the staged copy's type against x's dx rounded to it)."""
    rng = np.random.RandomState(D)
    B, T, H = 3, 7, 5
    x = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(
        np.float32)).to(dtype)
    y = torch.from_numpy(rng.uniform(-1, 1, (B, T, 2 * H)).astype(
        np.float32)).bfloat16()
    dz = torch.from_numpy(rng.uniform(-1, 1, (B, T, 2, 4 * H)).astype(
        np.float32)).bfloat16()
    Wx2 = torch.from_numpy(rng.uniform(-1, 1, (2, D, 4 * H)).astype(
        np.float32))
    xp = bk.staged_x(x)
    assert xp.dtype == torch.bfloat16 and xp.shape == (B, T, _up(D + 1, 64))
    assert torch.equal(xp[..., :D], x.bfloat16())
    assert bool((xp[..., D] == 1).all()) and bool((xp[..., D + 1:] == 0).all())
    dW_s, dx_s = tlstm.bidi_lstm_bwd_reduce_plain(xp[..., :D], y, dz, Wx2,
                                                  True, xz_bf16=True)
    dW_o, dx_o = tlstm.bidi_lstm_bwd_reduce_plain(x, y, dz, Wx2, True,
                                                  xz_bf16=True)
    assert torch.equal(dW_s, dW_o)
    assert dx_s.dtype == torch.bfloat16
    assert torch.equal(dx_s, dx_o.bfloat16())
