"""K1 and K4's state mode in the bf16 mode on the tensor cores
(csrc/bidi_lstm_fwd.cu, fwd16_kernel) and their plan, on CPU.

The kernel cannot run here, so what surrounds it is held here instead:
``fwd16_plan`` at the bench, filter, odd, large-batch and wide shapes
(every (row, unit) covered exactly once by a lane of one CTA, whole units
per CTA, the shared memory as csrc::geo16 counts it, one wave where the
card holds it, the FMA kernel where no plan fits and inside the window
where that kernel was the faster on the card), and a torch emulation of
the kernel's assembly: per direction and group of rows, per CTA its units
and their gate columns (``fwd16_weights``), the product per k16 tile on
bf16 operands (each tile's exact products summed in float64, rounded to
f32 and added in f32 in order, K1's [x | 1]·[Wx; b] first),
the gates read from the accumulator fragments by the lane arithmetic of
the kernel (one exchange within a pair of lanes), and h staged in bf16 and
all-gathered into the next step's operand in 16-byte chunks. The emulation
is held against ops/lstm.py's plain bf16 versions within EMU_RTOL of
max|·| (both round h, y and cell to bf16 where the JAX package does and sum
in f32, in other orders: a sum on the other side of a bf16 rounding moves
a value by one bf16 ulp and carries down the chain, while a wrong index
map moves it by its own size), and its y against the JAX package's
``bidi_lstm_pallas(..., xz_bf16=True)`` in interpret mode within
tests/test_torch_bf16.py's envelope.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402

# max|emulation - plain| over max|plain| (one bf16 ulp below 1), and the
# mean over max|plain|.
EMU_RTOL = 2.0 ** -8
EMU_MEAN_RTOL = 2.0 ** -14
# Against the TPU kernel's bf16 mode (tests/test_torch_bf16.py Y_MAX,
# Y_MEAN): max and mean |Δy|.
Y_MAX, Y_MEAN = 4e-3, 2e-4

# (B, D, H, hoist) -> (C, rows, units, waves) with the H100's cluster
# counts: the bench shapes (bidi K1, bidi2's K1 at layer 1 and K4 state at
# layer 2), the filter's K1 (D = 19, padded to 20), larger batches.
PINNED_PLAN = {(256, 48, 100, False): (3, 16, 40, 1),
               (256, 48, 200, False): (3, 16, 72, 1),
               (256, 0, 200, True): (3, 16, 72, 1),
               (256, 20, 100, False): (3, 16, 40, 1),
               (256, 0, 100, True): (3, 16, 40, 1),
               (512, 48, 100, False): (2, 16, 56, 1),
               (1024, 0, 200, True): (3, 16, 72, 4),
               (1024, 48, 100, False): (2, 16, 56, 2)}
# (B, D, H, hoist): the pinned shapes, odd and small ones (H not a multiple
# of 8 or of C, D = 2, B not a multiple of 16), and widths no plan holds
# (H = 700 and 2048; D = 402 at H = 200: [Wx; b] does not fit beside Wh).
SHAPES = (sorted(PINNED_PLAN)
          + [(b, d, h, False) for b in (1, 3, 17, 33)
             for d, h in ((6, 7), (2, 1), (50, 201), (130, 64), (48, 24))]
          + [(b, 0, h, True) for b in (1, 17, 40) for h in (7, 40, 201, 450)]
          + [(3, 6, 700, False), (3, 0, 700, True), (2, 4, 2048, False),
             (256, 402, 200, False)])
NO_PLAN = {(3, 6, 700, False), (3, 0, 700, True), (2, 4, 2048, False),
           (256, 402, 200, False), (1, 0, 450, True), (17, 0, 450, True),
           (40, 0, 450, True)}


def items(plan, nu):
    """The lane items of a CTA owning ``nu`` units, by the kernel's lane
    arithmetic -> (rows, units, zrows [n, 4], zcols [n, 4]): the item's row
    and unit, and where in the product Z [rows, 4·units] each of its four
    gates comes from (its own accumulator fragment, or its pair lane's
    through the exchange)."""
    mt = plan.rows // bk.FWD16_M
    ntc = (nu + 1) // 2
    rows, units, zr, zc = [], [], [], []
    for warp in range(bk.FWD16_WARPS):
        for i in range(bk.fwd16_ng(plan.rows)):
            j = warp + bk.FWD16_WARPS * i
            if j >= ntc:
                continue
            for m in range(mt):
                # Each lane's fragment: columns 2q, 2q+1 of n tile j at rows
                # lane/4 ([0..1]) and lane/4 + 8 ([2..3]) of the m tile.
                frag = {}
                for lane in range(32):
                    q, lo = lane % 4, m * 16 + lane // 4
                    cols = (8 * j + 2 * q, 8 * j + 2 * q + 1)
                    frag[lane] = [(lo, cols[0]), (lo, cols[1]),
                                  (lo + 8, cols[0]), (lo + 8, cols[1])]
                for lane in range(32):
                    odd = lane & 1
                    ru = lane // 4 + 8 * odd
                    ul = 2 * j + ((lane >> 1) & 1)
                    if ul >= nu:
                        continue
                    v, p = frag[lane], frag[lane ^ 1]
                    # The pair lane sends what this lane's row needs: the
                    # even lane its [2..3] (row + 8), the odd its [0..1].
                    sent = p[0:2] if not odd else p[2:4]
                    z = v[0:2] + sent if not odd else sent + v[2:4]
                    rows.append(m * 16 + ru)
                    units.append(ul)
                    zr.append([a for a, _ in z])
                    zc.append([b for _, b in z])
    return (torch.tensor(rows), torch.tensor(units), torch.tensor(zr),
            torch.tensor(zc))


def _tiles_sum(A, Bm, acc):
    """acc += A[:, k tile kt] · Bm[:, k tile kt]ᵀ over the k tiles of A
    [R, K] and Bm [N, K] in order: each tile's products exact, summed in
    float64 and rounded to f32, then added in f32."""
    for kt in range(A.shape[1] // 16):
        sl = slice(16 * kt, 16 * kt + 16)
        acc += (A[:, sl].double() @ Bm[:, sl].double().T).float()


def emulate_fwd16(pf, pr, inp, lengths, plan, state=True):
    """K1 (x [B, T, D] f32) or K4's state mode (xz [B, T, 2, 4H] bf16) as
    fwd16_kernel computes it at ``plan`` -> (y, gates, cell) as the plain
    versions return them, in f32 (y and cell bf16 values); without
    ``state``, K3 or K4 inference (the EMIT=false instances: the same
    chain, no gates or cell written) -> (y,)."""
    hoist = inp.dim() == 4
    B, T = inp.shape[:2]
    H = pf["Wh"].shape[0]
    C, R, U = plan.C, plan.rows, plan.units
    wx, wh = bk.fwd16_weights(pf, pr, not hoist)
    wh = wh.float()
    if hoist:
        D, xz = 0, inp.float()
    else:
        x = bk._x_bf16(inp).float()
        D, wx = x.shape[-1], wx.float()
    g = bk.fwd16_geometry(D, H, R, U, hoist, state=state)
    KH, KX, N = g["KH"], g["KX"], g["N"]
    L = (torch.full((B,), T) if lengths is None
         else lengths.long().clamp(0, T))
    y = torch.zeros(B, T, 2 * H)
    gates = torch.zeros(B, T, 2, 4 * H)
    cell = torch.zeros(B, T, 2, H)

    def bf(v):
        return v.to(torch.bfloat16).float()
    ctas = []
    for c in range(C):
        k0 = c * U
        nu = min(U, H - k0)
        assert nu > 0
        ctas.append((k0, nu, items(plan, nu)))
    for d in (0, 1):
        ops = []
        for k0, nu, _ in ctas:
            bh = torch.zeros(N, KH)
            bh[:4 * nu, :H] = wh[d, 4 * k0:4 * (k0 + nu)]
            bx = torch.zeros(N, KX)
            if not hoist:
                bx[:4 * nu, :D + 1] = wx[d, 4 * k0:4 * (k0 + nu)]
            ops.append((bh, bx))
        for b0 in range(0, B, R):
            lens = torch.zeros(R, dtype=torch.long)
            n = min(R, B - b0)
            lens[:n] = L[b0:b0 + n]
            lmax = int(lens.max())
            ah = torch.zeros(R, KH)
            carry = [(torch.zeros(len(it[0])), torch.zeros(len(it[0])))
                     for _, _, it in ctas]
            for s in range(lmax):
                on_r = s < lens
                t_r = (torch.full_like(lens, s) if d == 0
                       else (lens - 1 - s)).clamp(0, T - 1)
                b_r = (b0 + torch.arange(R)).clamp(max=B - 1)
                if not hoist:
                    ax = torch.zeros(R, KX)
                    ax[:, D] = 1.0
                    ax[on_r, :D] = x[b_r[on_r], t_r[on_r]]
                nxt = torch.zeros(R, KH)
                for (k0, nu, (rw, ul, zr, zc)), (bh, bx), st in zip(
                        ctas, ops, carry):
                    Z = torch.zeros(R, N)
                    if not hoist:
                        _tiles_sum(ax, bx, Z)
                    _tiles_sum(ah, bh, Z)
                    z = Z[zr, zc]                                  # [n, 4]
                    on = on_r[rw]
                    b, t, k = b_r[rw], t_r[rw], k0 + ul
                    if hoist:
                        cols = torch.arange(4)[None, :] * H + k[:, None]
                        z = z + torch.where(
                            on[:, None], xz[b[:, None], t[:, None], d, cols],
                            0.0)
                    gt = torch.cat([torch.sigmoid(z[:, :3]),
                                    torch.tanh(z[:, 3:])], 1)
                    cn = gt[:, 1] * st[0] + gt[:, 0] * gt[:, 3]
                    hn = torch.tanh(cn) * gt[:, 2]
                    st[0].copy_(torch.where(on, cn, st[0]))
                    st[1].copy_(torch.where(on, hn, st[1]))
                    # h staged in bf16, then its 16-byte chunks into the next
                    # operand: those starting below H.
                    hs = torch.zeros(R, U)
                    hs[rw, ul] = bf(st[1])
                    for ch in range(U // bk.FWD16_UNITS):
                        a = k0 + bk.FWD16_UNITS * ch
                        if a < H:
                            w8 = bk.FWD16_UNITS
                            nxt[:, a:a + w8] = hs[:, w8 * ch:w8 * (ch + 1)]
                    w = on & (b0 + rw < B)
                    bw, tw, kw = b[w], t[w], k[w]
                    y[bw, tw, d * H + kw] = bf(st[1][w])
                    if not state:
                        continue
                    cell[bw, tw, d, kw] = bf(st[0][w])
                    for gg in range(4):
                        gates[bw, tw, d, gg * H + kw] = gt[w, gg]
                ah = nxt
    return (y, gates, cell) if state else (y,)


def _owned(p, H):
    return [range(c * p.units, min(H, (c + 1) * p.units)) for c in range(p.C)]


@pytest.mark.parametrize("B,D,H,hoist", SHAPES)
def test_torch_fwd16_plan_covers_and_fits(B, D, H, hoist):
    p = bk.fwd16_plan(B, 900, D, H, hoist, state=True)
    if (B, D, H, hoist) in NO_PLAN:
        assert p == bk.FWD16_NONE, "the FMA kernel where no plan fits"
        # ... and that kernel has a plan there.
        assert bk.fwd_plan(B, D, H, hoist, True, esize=2).C
        return
    assert p.C in bk.FWD16_CLUSTER_SIZES and p.rows in bk.FWD16_ROWS
    assert p.units % bk.FWD16_UNITS == 0
    assert p.smem == bk.fwd16_smem(D, H, p.rows, p.units, hoist, p.C,
                                  state=True)
    assert 0 < p.smem <= bk.FWD16_SMEM_MAX
    assert p.units // 2 <= bk.FWD16_WARPS * bk.fwd16_ng(p.rows)
    # Rows: every row of the batch in exactly one group of a cluster.
    assert p.groups * p.rows >= B > (p.groups - 1) * p.rows
    # Units: every CTA owns whole units, the CTAs every unit once.
    owned = _owned(p, H)
    assert all(len(r) > 0 for r in owned)
    assert sorted(k for r in owned for k in r) == list(range(H))
    # Every (row, unit) of a group gets its gate math from exactly one lane
    # of one CTA, and each gate from the product column 4·unit + g.
    count = np.zeros((p.rows, H), np.int64)
    for c, r in enumerate(owned):
        rw, ul, zr, zc = items(p, len(r))
        np.add.at(count, (rw.numpy(), (r[0] + ul).numpy()), 1)
        assert torch.equal(zr, rw[:, None].expand(-1, 4))
        assert torch.equal(zc, 4 * ul[:, None] + torch.arange(4))
    assert (count == 1).all()


@pytest.mark.parametrize("B,D,H,hoist", sorted(PINNED_PLAN))
def test_torch_fwd16_plan_pinned_waves(B, D, H, hoist):
    # At a long chain: the plan is the cluster plan.
    p = bk.fwd16_plan(B, 900, D, H, hoist, state=True)
    assert p == bk.fwd16_cluster_plan(B, D, H, hoist, state=True)
    assert p.clusters == bk.H100_CLUSTERS[p.C]
    waves = -(-2 * p.groups // p.clusters)
    assert (p.C, p.rows, p.units, waves) == PINNED_PLAN[(B, D, H, hoist)]


def test_torch_fwd16_smem_layout():
    """fwd16_smem counts what csrc::geo16 lays out: the B operand [4U][KH +
    KX + 8] bf16, h [2][R][KH+8] and the x ring [3][R][KX+8] (K1) or the
    xz ring [3][R][4][U] (K4) bf16, the
    output stage of both parities (gates [2][R][4U + 2] f32, h and c
    [2][R][U] bf16), each a multiple of 16 bytes (16-byte copies), operand
    rows an odd multiple of 16 bytes apart (ldmatrix's 8 rows in 8 bank
    groups)."""
    for D, H, R, U, hoist in ((48, 100, 16, 40, False), (0, 200, 16, 72, True),
                              (20, 7, 32, 8, False), (130, 64, 16, 8, False)):
        g = bk.fwd16_geometry(D, H, R, U, hoist, state=True)
        KH, KX = -(-H // 16) * 16, 0 if hoist else -(-(D + 1) // 16) * 16
        assert g["bytes"] == 2 * (4 * U * (KH + KX + 8) + 2 * R * (KH + 8)
                                  + 3 * R * (4 * U if hoist else KX + 8)
                                  + 2 * R * (4 * U + 2) * 2 + 4 * R * U)
        for part in ("bw", "ah", "ax", "gs", "hs", "cs"):
            assert g[part] % 16 == 0
        for ld in (KH + KX + 8, KH + 8) + (() if hoist else (KX + 8,)):
            assert (2 * ld) % 32 == 16
        C = -(-H // U)
        assert bk.fwd16_smem(D, H, R, U, hoist, C, state=True) in (
            0, g["bytes"])
    # The widest bench CTA, bidi2's K1 at layer 1, fits.
    assert bk.fwd16_smem(48, 200, 16, 72, False, 3, state=True) == \
        bk.fwd16_geometry(48, 200, 16, 72, False, state=True)["bytes"] \
        <= bk.FWD16_SMEM_MAX


# (T, H) -> whether the plan is the FMA kernel: the window where it beat
# the fwd16 kernel on the card (fwd16_prefers_old), and around it.
WINDOW = {(1, 100): True, (16, 100): True, (32, 100): True, (33, 100): False,
          (64, 100): False, (900, 100): False, (32, 40): True,
          (32, 101): False, (16, 101): True, (16, 200): True,
          (17, 200): False, (16, 201): False, (900, 200): False}


@pytest.mark.parametrize("T,H", sorted(WINDOW))
def test_torch_fwd16_plan_window(T, H):
    """Where the FMA kernel was the faster on the card (fwd16_prefers_old),
    the plan is FWD16_NONE; elsewhere the cluster plan, for K1 and K4's
    state mode."""
    for D, hoist in ((48, False), (0, True)):
        p = bk.fwd16_plan(256, T, D, H, hoist, state=True)
        if WINDOW[(T, H)]:
            assert p == bk.FWD16_NONE
        else:
            assert p.C and p == bk.fwd16_cluster_plan(256, D, H, hoist,
                                                      state=True)
    assert bk.fwd16_prefers_old(T, H) == WINDOW[(T, H)]


def test_torch_fwd16_plan_follows_the_card():
    """A card that holds fewer clusters moves the plan (more rows, another
    C), never to a failure; a forced C or rows is taken where it fits."""
    p = bk.fwd16_cluster_plan(256, 48, 200, False, lambda C, r, u: 8,
                              state=True)
    assert p.C and p.clusters == 8 and p.groups * p.rows >= 256
    q = bk.fwd16_cluster_plan(256, 48, 100, False, C=3, rows=32, state=True)
    assert (q.C, q.rows) == (3, 32)
    assert bk.fwd16_cluster_plan(256, 48, 200, False, C=1,
                                 state=True) == bk.FWD16_NONE


# (T, hoist) -> the C entry a bf16 call of B=3, D=6 (K1) and H=5 launches:
# the fwd16 kernel past the window, the FMA kernel's bf16 instance inside it.
ROUTE = {(64, False): "clstm_bidi_lstm_fwd16_state",
         (64, True): "clstm_bidi_lstm_fwd16_xz_state",
         (4, False): "clstm_bidi_lstm_fwd_state_bf16",
         (4, True): "clstm_bidi_lstm_fwd_xz_state_bf16"}


@pytest.mark.parametrize("T,hoist", sorted(ROUTE))
def test_torch_fwd16_launch_route_and_counts(T, hoist, monkeypatch):
    """bidi_lstm_fwd_state (K1) and bidi_lstm_fwd_state_xz (K4's state
    mode) in the bf16 mode launch the entry of the plan's kernel once a
    call, add one to ``launches`` and, on the fwd16 kernel, one to
    ``launches16``; the same wrapper in the f32 mode never takes the fwd16
    kernel; an empty batch launches and counts nothing. The wrappers run on
    meta tensors with the C entry points replaced by a recorder."""
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
    D, H = 6, 5
    wrapper = bk.bidi_lstm_fwd_state_xz if hoist else bk.bidi_lstm_fwd_state
    monkeypatch.setattr(wrapper, "launches", 0)
    monkeypatch.setattr(wrapper, "launches16", 0)

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    def call(B, T_, bf16):
        pf, pr = ({"Wx": m(D, 4 * H), "Wh": m(H, 4 * H), "b": m(4 * H)}
                  for _ in range(2))
        inp = (m(B, T_, 2, 4 * H, dtype=torch.bfloat16 if bf16 else
                 torch.float32) if hoist else m(B, T_, D))
        return wrapper(pf, pr, inp, xz_bf16=bf16)
    for B, T_ in ((0, T), (3, 0)):
        y, gates, cell = call(B, T_, True)
        assert y.shape == (B, T_, 2 * H) and gates.shape == (B, T_, 2, 4 * H)
        assert cell.shape == (B, T_, 2, H)
    assert not launched and wrapper.launches == wrapper.launches16 == 0
    plan = bk.fwd16_plan(3, T, 0 if hoist else D, H, hoist, state=True)
    y, gates, cell = call(3, T, True)
    assert (y.dtype, gates.dtype, cell.dtype) == (
        torch.bfloat16, torch.float32, torch.bfloat16)
    assert [n for n, _ in launched] == [ROUTE[(T, hoist)]]
    assert wrapper.launches == 1
    assert wrapper.launches16 == (1 if plan.C else 0)
    if plan.C:
        assert launched[0][1] == (plan.C, plan.rows, plan.units)
    call(3, T, False)
    assert launched[-1][0] == ("clstm_bidi_lstm_fwd_xz_state" if hoist
                               else "clstm_bidi_lstm_fwd_state")
    assert wrapper.launches == 2 and wrapper.launches16 == (1 if plan.C
                                                            else 0)


def test_torch_fwd16_weights_layout():
    """fwd16_weights: row 4·u + g of each direction holds the column of
    gate g of unit u, k contiguous; [Wx; 0 for an odd D; b] for the x
    part, in bf16."""
    rng = np.random.RandomState(3)
    D, H = 5, 3
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    wx, wh = bk.fwd16_weights(pf, pr, True)
    assert wx.dtype == wh.dtype == torch.bfloat16
    assert wx.shape == (2, 4 * H, D + 2) and wh.shape == (2, 4 * H, H)
    for d, p in enumerate((pf, pr)):
        for u in range(H):
            for g in range(4):
                n = 4 * u + g
                assert torch.equal(wh[d, n], p["Wh"][:, g * H + u].bfloat16())
                assert torch.equal(wx[d, n, :D],
                                   p["Wx"][:, g * H + u].bfloat16())
                assert wx[d, n, D] == 0
                assert wx[d, n, D + 1] == p["b"][g * H + u].bfloat16()
    assert bk.fwd16_weights(pf, pr, False)[0] is None


def _params(rng, D, H, scale=None):
    scale = scale or min(0.5, 3.0 / H ** 0.5)
    return {n: torch.from_numpy(rng.uniform(-scale, scale, s)
                                .astype(np.float32))
            for n, s in (("Wx", (D, 4 * H)), ("Wh", (H, 4 * H)),
                         ("b", (4 * H,)))}


def _inputs(B, T, D, H, seed):
    rng = np.random.RandomState(seed)
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(np.float32))
    lens = rng.randint(0, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = 0, T
    return pf, pr, x, torch.from_numpy(lens)


# (B, T, D, H, hoist, C, rows): at the plan (C None), and at forced plans
# the emulation would not reach otherwise: 32 rows (two m16 tiles), C=2 and
# C=4 with a short last CTA, C=8, an odd D (padded), H not a multiple of 8.
EMU_CASES = [(3, 6, 6, 7, False, None, None),
             (17, 5, 48, 24, False, None, None),
             (5, 7, 5, 40, False, 2, None), (17, 4, 6, 33, False, None, 32),
             (3, 5, 0, 7, True, None, None), (5, 6, 0, 40, True, 3, None),
             (4, 4, 0, 201, True, 4, None), (5, 4, 0, 40, True, None, 32),
             (3, 4, 9, 64, False, 8, None)]


@pytest.mark.parametrize("B,T,D,H,hoist,C,rows", EMU_CASES)
def test_torch_fwd16_emulation_matches_plain(B, T, D, H, hoist, C, rows):
    pf, pr, x, L = _inputs(B, T, max(D, 3), H, B * 1000 + H)
    if hoist:
        inp = tlstm.hoisted_projection(pf, pr, x, xz_bf16=True)
        want = tlstm.bidi_lstm_fwd_state_xz_plain(pf, pr, inp, L,
                                                  xz_bf16=True)
    else:
        inp = x
        want = tlstm.bidi_lstm_fwd_state_plain(pf, pr, x, L, xz_bf16=True)
    d = 0 if hoist else x.shape[-1] + x.shape[-1] % 2
    plan = bk.fwd16_cluster_plan(B, d, H, hoist, C=C, rows=rows, state=True)
    assert plan.C and plan.C == (C or plan.C)
    assert plan.rows == (rows or plan.rows)
    with torch.no_grad():
        got = emulate_fwd16(pf, pr, inp, L, plan)
    pad = torch.arange(T)[None, :] >= L[:, None]
    for name, k, p in zip(("y", "gates", "cell"), got, want):
        p = p.float()
        scale = float(p.abs().max())
        assert scale > 0
        assert bool((k[pad] == 0).all()), name
        err = (k - p).abs()
        assert float(err.max()) <= EMU_RTOL * scale, (name, err.max())
        assert float(err.mean()) <= EMU_MEAN_RTOL * scale, (name, err.mean())
    # The wrappers on CPU tensors run the plain versions.
    fn = bk.bidi_lstm_fwd_state_xz if hoist else bk.bidi_lstm_fwd_state
    cpu = fn(pf, pr, inp, L, xz_bf16=True)
    assert all(torch.equal(a, b) for a, b in zip(cpu, want))


@pytest.mark.parametrize("B,T,D,H", [(5, 12, 6, 24), (32, 9, 20, 40),
                                     (7, 10, 130, 40)])
def test_torch_fwd16_emulation_matches_pallas_interpret(B, T, D, H):
    """The emulation's y against the JAX package's bf16 mode (the TPU
    kernel in interpret mode): K1 where the layer keeps the projection
    inside, K4's state mode on the bf16 hoisted product where it hoists
    (D = 130 > 128)."""
    jnp = pytest.importorskip("jax.numpy")
    from clstm_tpu.ops.pallas_lstm import bidi_lstm_pallas

    pf, pr, x, L = _inputs(B, T, D, H, 7 * B + H)
    hoist = bk.hoists_projection(D, H)
    assert hoist == (D == 130)
    want = np.asarray(bidi_lstm_pallas(
        {k: jnp.asarray(v.numpy()) for k, v in pf.items()},
        {k: jnp.asarray(v.numpy()) for k, v in pr.items()},
        jnp.asarray(x.numpy()), jnp.asarray(L.numpy()), 8, True,
        True).astype(jnp.float32))
    inp = (tlstm.hoisted_projection(pf, pr, x, xz_bf16=True) if hoist
           else x)
    d = 0 if hoist else D + D % 2
    plan = bk.fwd16_cluster_plan(B, d, H, hoist, state=True)
    with torch.no_grad():
        y = emulate_fwd16(pf, pr, inp, L, plan)[0]
    diff = np.abs(y.numpy() - want)
    assert diff.max() <= Y_MAX and diff.mean() <= Y_MEAN, (diff.max(),
                                                           diff.mean())
