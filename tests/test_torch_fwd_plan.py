"""The forward kernel's plan and index maps (csrc/bidi_lstm_fwd.cu, K3, K1
and K4), on CPU.

The kernel cannot run here, so what surrounds it is held here instead:
``fwd_plan`` at the bench shapes, at the odd shapes of chip_smoke.py and at
widths that cross its edges (every (row, unit) covered exactly once, whole
units per CTA, the cluster sizes, the shared-memory budget, which shapes
keep their weights resident), and a torch emulation of the forward
assembled the way the kernel assembles it: per direction and row group, per
CTA of the cluster its units (all four gate columns, from the weights
interleaved by ``fwd_weights``), per thread the tile that the thread index
maps to, each tile's sum split over the two halves of a warp and each half
taking its share of the rows for the gate math and the stores. The
emulation must equal the plain versions within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402

# (B, D, H, hoist, state). The bench shapes: bidi (K3, K1), bidi2's first
# layer (K1, K3) and second layer (K4, both modes).
BENCH = [(256, 48, 100, False, False), (256, 48, 100, False, True),
         (256, 48, 200, False, True), (256, 48, 200, False, False),
         (256, 0, 200, True, False), (256, 0, 200, True, True)]
# The plan each bench shape takes with the H100's cluster counts: C, rows
# per cluster, weights resident (1: all, 2: Wh's only).
BENCH_PLAN = {(256, 48, 100): (2, 8, 1), (256, 48, 200): (4, 20, 2),
              (256, 0, 200): (4, 20, 1)}
# chip_smoke.py's odd shapes (B, T, D, H) and widths across the plan's
# edges: H not a multiple of C, B below and not a multiple of the rows per
# cluster, H = 700 and 2048 on the L2 plan.
ODD = [(5, 3, 7), (3, 49, 300), (9, 48, 100), (2, 1, 1), (3, 130, 7),
       (5, 401, 200), (4, 5, 700), (2, 3, 2048)]
WIDTHS = [(b, d, h) for b in (1, 3, 17) for d, h in
          ((5, 1), (5, 3), (5, 7), (48, 201), (5, 700), (3, 2048))]


def _cases():
    out = [c for c in BENCH]
    for b, d, h in ODD + WIDTHS:
        out += [(b, d, h, False, False), (b, d, h, False, True),
                (b, 0, h, True, True)]
    return out


def _tiles(plan):
    """(thread, half, unit index in the CTA, first row of the tile, first
    row of the half) for every thread of a CTA that computes, by the
    kernel's map: two threads per tile, in the two halves of a warp."""
    out = []
    ntiles = plan.units * (plan.rows // 4)
    for tid in range(plan.threads):
        lane, hf = tid & 31, (tid & 31) >> 4
        tile = (tid >> 5) * 16 + (lane & 15)
        if tile >= ntiles:
            continue
        ul, rb = tile % plan.units, (tile // plan.units) * 4
        out.append((tid, hf, ul, rb, rb + 2 * hf))
    return out


@pytest.mark.parametrize("B,D,H,hoist,state", _cases())
def test_torch_fwd_plan_covers_and_fits(B, D, H, hoist, state):
    p = bk.fwd_plan(B, D, H, hoist, state)
    assert p.C in (1, 2, 4, 8)
    assert p.rows % 4 == 0 and p.rows >= 4
    assert p.smem == bk.fwd_smem(D, H, p.rows, p.units, hoist, p.resident)
    assert p.smem <= bk.SMEM_MAX and p.threads <= bk.FWD_THREADS
    assert p.threads == bk.fwd_threads(p.rows, p.units)
    assert p.groups * p.rows >= B > (p.groups - 1) * p.rows
    # Every CTA owns at least one whole unit, and the CTAs all of them.
    owned = [range(c * p.units, min(H, (c + 1) * p.units))
             for c in range(p.C)]
    assert all(len(r) > 0 for r in owned)
    assert sorted(k for r in owned for k in r) == list(range(H))
    # Every (row, unit) of the batch gets its gate math from exactly one
    # thread, and each tile's sum from two threads of one warp.
    count = np.zeros((p.groups * p.rows, H), np.int64)
    tiles = _tiles(p)
    for g in range(p.groups):
        for c, units in enumerate(owned):
            for tid, hf, ul, rb, r0 in tiles:
                if ul >= len(units):
                    continue
                rows = g * p.rows + r0 + np.arange(2)
                count[rows, units[0] + ul] += 1
    assert (count[:B] == 1).all()
    pairs = {}
    for tid, hf, ul, rb, r0 in tiles:
        pairs.setdefault((ul, rb), []).append((tid >> 5, hf))
    assert all(sorted(h for _, h in v) == [0, 1] and v[0][0] == v[1][0]
               for v in pairs.values())


@pytest.mark.parametrize("B,D,H", list(BENCH_PLAN))
def test_torch_fwd_plan_bench_shapes_resident(B, D, H):
    C, rows, resident = BENCH_PLAN[(B, D, H)]
    for state in (False, True):
        p = bk.fwd_plan(B, D, H, D == 0, state)
        assert (p.C, p.rows, p.resident) == (C, rows, resident)
        assert 2 * p.groups <= p.clusters   # one wave


@pytest.mark.parametrize("H", [700, 2048])
def test_torch_fwd_plan_wide_takes_l2(H):
    """H = 700 and 2048 read the weights from L2: in one wave at the
    smallest cluster whose tiles fit a CTA's threads where the batch
    allows it, else at the C with the most rows."""
    for B in (1, 3, 17, 256):
        for hoist in (False, True):
            p = bk.fwd_plan(B, 0 if hoist else 5, H, hoist, True)
            assert not p.resident
            assert p.C == (8 if H == 2048 or B == 256 else 4)
            assert (2 * p.groups <= p.clusters) == (B < 256)


def test_torch_fwd_plan_wide_input_l2_one_wave():
    """A wide input that does not hoist (D = 100, 255 and 400 at H = 200)
    reads the weights from L2 at C = 4, 20 rows: one wave, each weight
    load shared by 20 rows, where C = 1 and 2 share it by 4 and 8."""
    for D in (100, 255, 400):
        p = bk.fwd_plan(256, D, 200, False, False)
        assert (p.C, p.rows, p.resident) == (4, 20, 0)


def test_torch_fwd_plan_follows_the_cards_cluster_count():
    """The rows per cluster come from the card's count at the plan: with
    more clusters of 4, bidi2's second layer takes fewer rows, and where the
    rows that one wave needs do not fit a CTA, Wh's slice alone or the next
    cluster size."""
    p = bk.fwd_plan(256, 0, 200, True, True,
                    lambda C, resident, rows, units: {4: 34}.get(C, 15))
    assert (p.C, p.rows, p.groups) == (4, 16, 16)
    q = bk.fwd_plan(256, 48, 200, False, True,
                    lambda C, resident, rows, units: 15)
    assert (q.C, q.rows, q.resident) == (8, 40, 1)


def _emulate(pf, pr, inp, lengths, hoist, plan):
    """The forward as the kernel assembles it from the plan (see the module
    docstring) -> (y, gates, cell) as the plain versions return them."""
    B, T = inp.shape[:2]
    H = pf["Wh"].shape[0]
    wx, wh = bk.fwd_weights(pf, pr, not hoist)    # [2,D+1,H,4], [2,H,H,4]
    D = 0 if hoist else inp.shape[2]
    L = (torch.full((B,), T) if lengths is None
         else lengths.long().clamp(0, T))
    y = torch.zeros(B, T, 2 * H)
    gates = torch.zeros(B, T, 2, 4 * H)
    cell = torch.zeros(B, T, 2, H)
    R, U = plan.rows, plan.units
    hh, dh = (H + 1) // 2, (D + 1) // 2
    tiles = _tiles(plan)
    for d in range(2):
        for g in range(plan.groups):
            lens = [int(L[b]) if b < B else 0 for b in range(g * R, g * R + R)]
            lmax = max(lens)
            h = torch.zeros(R, H)
            c = torch.zeros(R, H)
            for s in range(lmax):
                # Each row's input at chain step s (zero past its length).
                a = torch.zeros(R, 4 * H if hoist else D)
                for r, n in enumerate(lens):
                    if s < n:
                        t = s if d == 0 else n - 1 - s
                        a[r] = inp[g * R + r, t, d] if hoist else \
                            inp[g * R + r, t]
                h_next, c_next = h.clone(), c.clone()
                for cta in range(plan.C):
                    k0 = cta * U
                    nu = min(U, H - k0)
                    for tid, hf, ul, rb, r0 in tiles:
                        if ul >= nu:
                            continue
                        k = k0 + ul
                        rows = slice(rb, rb + 4)
                        # The two halves' sums: k < hh and d < dh (and the
                        # bias) in half 0, the rest in half 1.
                        part = []
                        for half in (0, 1):
                            ks = slice(0, hh) if half == 0 else slice(hh, H)
                            z = h[rows, ks] @ wh[d, ks, k]
                            if not hoist:
                                ds = slice(0, dh) if half == 0 else \
                                    slice(dh, D)
                                z = z + a[rows, ds] @ wx[d, ds, k]
                                if half == 0:
                                    z = z + wx[d, D, k]
                            part.append(z)
                        z = part[0] + part[1]                      # [4, 4]
                        if hoist:
                            z = z + a[rows][:, [k, H + k, 2 * H + k,
                                                3 * H + k]]
                        # This half's rows: gate math, state and stores.
                        for i in range(2):
                            r = r0 + i
                            if s >= lens[r]:
                                continue
                            zi = z[r - rb]
                            gt = torch.cat([torch.sigmoid(zi[:3]),
                                            torch.tanh(zi[3:])])
                            cn = gt[1] * c[r, k] + gt[0] * gt[3]
                            hn = torch.tanh(cn) * gt[2]
                            c_next[r, k], h_next[r, k] = cn, hn
                            b = g * R + r
                            t = s if d == 0 else lens[r] - 1 - s
                            y[b, t, d * H + k] = hn
                            gates[b, t, d, [k, H + k, 2 * H + k,
                                            3 * H + k]] = gt
                            cell[b, t, d, k] = cn
                h, c = h_next, c_next
    return y, gates, cell


def _params(rng, D, H, scale=0.5):
    return {n: torch.from_numpy(rng.uniform(-scale, scale, s)
                                .astype(np.float32))
            for n, s in (("Wx", (D, 4 * H)), ("Wh", (H, 4 * H)),
                         ("b", (4 * H,)))}


@pytest.mark.parametrize("B,T,D,H,hoist,state", [
    (5, 4, 3, 7, False, True), (3, 3, 49, 9, False, False),
    (17, 3, 5, 7, False, True), (2, 5, 1, 1, False, True),
    (3, 4, 6, 7, True, True), (17, 2, 5, 3, True, False),
    (3, 3, 5, 20, False, True)])
def test_torch_fwd_emulation_matches_plain(B, T, D, H, hoist, state):
    """The plan's index maps reproduce the plain forward, at plans whose
    clusters have one CTA or several, with row groups of one row and of
    many, and rows of length 0 and T."""
    rng = np.random.RandomState(B * 31 + H)
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(np.float32))
    lens = rng.randint(0, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = 0, T
    lengths = torch.from_numpy(lens)
    # At most 4 clusters of any size: two row groups per direction.
    plan = bk.fwd_plan(B, 0 if hoist else D, H, hoist, state,
                       lambda C, resident, rows, units: 4)
    with torch.no_grad():
        if hoist:
            inp = tlstm.hoisted_projection(pf, pr, x)
            want = tlstm.bidi_lstm_fwd_state_xz_plain(pf, pr, inp, lengths)
        else:
            inp = x
            want = tlstm.bidi_lstm_fwd_state_plain(pf, pr, x, lengths)
        got = _emulate(pf, pr, inp, lengths, hoist, plan)
    for k, p in zip(got, want):
        assert float((k - p).abs().max()) <= 1e-6


def test_torch_fwd_emulation_spans_clusters():
    """A plan with several CTAs per cluster and several row groups: each
    CTA's units come from its own slice of the interleaved weights."""
    rng = np.random.RandomState(7)
    B, T, D, H = 9, 3, 4, 10
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(np.float32))
    lengths = torch.tensor([3, 0, 2, 3, 1, 3, 2, 3, 3], dtype=torch.int32)
    plan = bk.FwdPlan(C=4, rows=4, units=3, resident=1,
                      threads=bk.fwd_threads(4, 3),
                      smem=bk.fwd_smem(D, H, 4, 3, False, 1),
                      groups=3, clusters=4)
    with torch.no_grad():
        got = _emulate(pf, pr, x, lengths, False, plan)
        want = tlstm.bidi_lstm_fwd_state_plain(pf, pr, x, lengths)
    for k, p in zip(got, want):
        assert float((k - p).abs().max()) <= 1e-6


def test_torch_interleave_gates_layout():
    """fwd_weights puts Wh[k, g·H + u] at wh[dir, k, u, g], and the bias as
    the last row of wx."""
    rng = np.random.RandomState(3)
    D, H = 3, 5
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    wx, wh = bk.fwd_weights(pf, pr, True)
    assert wx.shape == (2, D + 1, H, 4) and wh.shape == (2, H, H, 4)
    for d, p in enumerate((pf, pr)):
        for u in range(H):
            for g in range(4):
                assert torch.equal(wh[d, :, u, g], p["Wh"][:, g * H + u])
                assert torch.equal(wx[d, :D, u, g], p["Wx"][:, g * H + u])
                assert wx[d, D, u, g] == p["b"][g * H + u]
    assert bk.fwd_weights(pf, pr, False)[0] is None
