"""K2's bf16 chain on thread-block clusters (csrc/bidi_lstm_bwd.cu,
bwd_chain16_kernel) and its plan, on CPU.

The kernel cannot run here, so what surrounds it is held here instead:
``chain_plan`` at the bench, filter, odd, large-batch and wide shapes
(every (row, unit) covered exactly once, whole units per CTA, every dz
column in exactly one place of the product's operand, shared memory within
budget, one wave where the card holds it, the L2 branch where no cluster
holds a slice of Wh and where it was the faster on the card), and a torch emulation of the chain assembled the way the
kernel assembles it: per direction and group of rows, per CTA of the
cluster its units and dz columns, the product Dh = dz·Whᵀ on bf16 operands
accumulated in f32 per k tile of 16 (even and odd tiles apart, k ranges
added in order), and the reduce-scatter of partial Dh summed over the CTAs
in order. The emulation must equal
ops/lstm.py::bidi_lstm_bwd_chain_plain(xz_bf16=True) within EMU_RTOL of
max|dz|: both round dz to bf16 where the JAX package does and sum in f32,
in other orders, so a sum that lands on the other side of a bf16 rounding
moves that dz by one bf16 ulp (2^-8 relative) and carries down the chain
(at these shapes none did: 1.5e-6 of max|dz| at most); a wrong index map
moves dz by its own size.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402

# max|emulation - plain| over max|plain| (one bf16 ulp below 1), and the
# mean over max|plain|.
EMU_RTOL = 2.0 ** -8
EMU_MEAN_RTOL = 2.0 ** -16
# A long chain: the bench shapes' valid frames.
LONG_T = 900

# (B, H) -> (C, rows, units, ksplit, waves) at a long chain: the bench
# shapes (bidi, and bidi2's two layers at H=200), and larger batches (C=2
# and C=1 with 16 rows, C=4 with 32; at B=1024, H=200 no plan takes one
# wave).
PINNED_PLAN = {(256, 100): (3, 16, 36, 4, 1), (256, 200): (3, 16, 68, 2, 1),
               (512, 100): (2, 16, 52, 4, 1), (512, 200): (2, 16, 100, 2, 1),
               (1024, 100): (1, 16, 100, 4, 1),
               (1024, 200): (2, 16, 100, 2, 2), (384, 209): (4, 32, 53, 1, 1)}
# (B, H): the bench and filter shapes, odd and small ones, larger batches,
# and the widths no cluster holds (H=700, 2048).
SHAPES = ([(b, h) for b in (1, 3, 17, 256) for h in (1, 7, 33, 100, 200,
                                                    201)]
          + [(5, 201), (2, 1), (256, 300), (256, 700), (3, 2048)]
          + [k for k in PINNED_PLAN if k[0] > 256])


def _owned(p, H):
    return [range(c * p.units, min(H, (c + 1) * p.units)) for c in range(p.C)]


@pytest.mark.parametrize("B,H", SHAPES)
def test_torch_chain_plan_covers_and_fits(B, H):
    p = bk.chain_cluster_plan(B, H)
    if H >= 700:
        assert p.C == 0, "no cluster holds a slice of Wh at this width"
        return
    assert p.C in bk.CHAIN_CLUSTER_SIZES and p.rows in bk.CHAIN_ROWS
    assert p.smem == bk.chain_smem(H, p.C, p.rows, p.units, p.ksplit)
    assert 0 < p.smem <= bk.CHAIN_SMEM_MAX
    g = bk.chain_geometry(H, p.C, p.rows, p.units, p.ksplit)
    assert 1 <= p.ksplit <= g["K"] // 16
    # Rows: every row of the batch in exactly one group of a cluster.
    assert p.groups * p.rows >= B > (p.groups - 1) * p.rows
    # Units: every CTA owns whole units (all four gate columns), and the
    # CTAs every unit once; a quad of units a thread.
    owned = _owned(p, H)
    assert all(len(r) > 0 for r in owned)
    assert sorted(k for r in owned for k in r) == list(range(H))
    assert p.rows * -(-p.units // bk.CHAIN_QUAD) <= bk.CHAIN_THREADS
    if H % bk.CHAIN_QUAD == 0:
        assert p.units % bk.CHAIN_QUAD == 0
    # dz columns: CTA c's A holds its columns g·H + k at g·U + (k - c·U),
    # each once, within K.
    for c, r in enumerate(owned):
        pos = {gg * p.units + k - c * p.units: gg * H + k
               for gg in range(4) for k in r}
        assert len(pos) == 4 * len(r) and max(pos) < g["K"]


@pytest.mark.parametrize("B,H", sorted(PINNED_PLAN))
def test_torch_chain_plan_pinned_waves(B, H):
    p = bk.chain_plan(B, LONG_T, H, 2)
    assert p == bk.chain_cluster_plan(B, H)
    assert p.clusters == bk.H100_CLUSTERS[p.C]
    waves = -(-2 * p.groups // p.clusters)
    assert (p.C, p.rows, p.units, p.ksplit, waves) == PINNED_PLAN[(B, H)]


@pytest.mark.parametrize("H", [1, 100, 200, 2048])
def test_torch_chain_plan_branches(H):
    # The f32 mode keeps the L2 kernel's own plan; a card that holds fewer
    # clusters moves the plan, never to a failure.
    assert bk.chain_plan(256, LONG_T, H, 4) == bk.CHAIN_L2
    p = bk.chain_cluster_plan(256, H, clusters=lambda *a: 1)
    assert p.C == (0 if H == 2048 else p.C)
    if p.C:
        assert p.clusters == 1 and p.groups * p.rows >= 256


# (T, H) -> whether the plan is the L2 branch: the window where it beat
# the cluster plan on the card (chain_prefers_l2), and around it.
L2_WINDOW = {(1, 64): False, (15, 64): False, (16, 64): True,
             (900, 64): True, (16, 80): True, (900, 80): True,
             (15, 100): False, (16, 100): True, (32, 100): True,
             (64, 100): True, (65, 100): False, (900, 100): False,
             (32, 101): False, (32, 143): False, (32, 200): False,
             (900, 200): False}


@pytest.mark.parametrize("T,H", sorted(L2_WINDOW))
def test_torch_chain_plan_l2_window(T, H):
    p = bk.chain_plan(256, T, H, 2)
    assert bk.chain_prefers_l2(T, H) == L2_WINDOW[(T, H)]
    if L2_WINDOW[(T, H)]:
        assert p == bk.CHAIN_L2
    else:
        assert p.C and p == bk.chain_cluster_plan(256, H)


def test_torch_chain_plan_filter_shape():
    # The filter path's chain (B=256, T=32, H=100) takes the L2 branch;
    # bidi's (T=1024) and bidi2's (H=200) the cluster plan.
    assert bk.chain_plan(256, 32, 100, 2) == bk.CHAIN_L2
    assert bk.chain_plan(256, 1024, 100, 2).C == 3
    assert bk.chain_plan(256, 1024, 200, 2).C == 3


def _ksum(A, Bm, ks):
    """A [R, K] · Bm [N, K]ᵀ as the kernel sums it: k tiles of 16, each
    tile's products exact and summed in float64 then rounded to f32, the
    even and odd tiles of a k range in two f32 accumulators added at its
    end, the ks ranges added in order."""
    KT = A.shape[1] // 16
    total = None
    for q in range(ks):
        k0, k1 = q * KT // ks, (q + 1) * KT // ks
        acc = [torch.zeros((A.shape[0], Bm.shape[0])) for _ in range(2)]
        for kt in range(k0, k1):
            sl = slice(16 * kt, 16 * kt + 16)
            acc[(kt - k0) % 2] += (A[:, sl].double() @ Bm[:, sl].double().T
                                   ).float()
        part = acc[0] + acc[1]
        total = part if total is None else total + part
    return total


def emulate_chain16(gates, cell, gy, Wh2, lengths, plan):
    """K2's bf16 chain as bwd_chain16_kernel computes it at ``plan`` -> dz
    [B, T, 2, 4H] in f32 (bf16 values), 0 on padded frames."""
    B, T, _, G = gates.shape
    H = G // 4
    C, R, U, ks = plan.C, plan.rows, plan.units, plan.ksplit
    g = bk.chain_geometry(H, C, R, U, ks)
    K, N = g["K"], g["N"]
    L = (torch.full((B,), T) if lengths is None
         else lengths.long().clamp(0, T))
    wh = Wh2.to(torch.bfloat16).float()
    owned = [(c * U, min(H, (c + 1) * U)) for c in range(C)]
    dz = torch.zeros((B, T, 2, G))

    def bf(v):
        return v.to(torch.bfloat16).float()
    for d in (0, 1):
        # Each CTA's rows of Whᵀ, zero where no dz column is.
        Bs = []
        for c, (a, b) in enumerate(owned):
            m = torch.zeros((N, K))
            for gg in range(4):
                m[:H, gg * U:gg * U + b - a] = wh[d][:, gg * H + a:gg * H + b]
            Bs.append(m)
        for r0 in range(0, B, R):
            rows = torch.arange(r0, min(B, r0 + R))
            Lr = torch.zeros(R, dtype=torch.long)
            Lr[:len(rows)] = L[rows]
            lmax = int(Lr.max())
            Dc = torch.zeros((R, H))
            Dh = torch.zeros((R, H))
            for s in range(lmax - 1, -1, -1):
                on = s < Lr
                t = torch.where(torch.tensor(d == 0), torch.full_like(Lr, s),
                                Lr - 1 - s).clamp(0, T - 1)
                rr = torch.cat([rows, torch.zeros(R - len(rows),
                                                  dtype=torch.long)])
                gt = gates[rr, t, d]
                gi, gf, go, ci = gt.split(H, dim=-1)
                c = cell[rr, t, d].float()
                tp = (t - 1 if d == 0 else t + 1).clamp(0, T - 1)
                cp = cell[rr, tp, d].float() * (s > 0)
                dh = gy[rr, t, d * H:(d + 1) * H].float() + torch.where(
                    (s < Lr - 1)[:, None], Dh, 0.0)
                tc = torch.tanh(c)
                dc = Dc + dh * go * (1 - tc * tc)
                z = bf(torch.cat([dc * ci * gi * (1 - gi),
                                  dc * cp * gf * (1 - gf),
                                  dh * tc * go * (1 - go),
                                  dc * gi * (1 - ci * ci)], -1))
                z = torch.where(on[:, None], z, 0.0)
                Dc = torch.where(on[:, None], dc * gf, Dc)
                n = len(rows)
                dz[rows[on[:n]], t[:n][on[:n]], d] = z[:n][on[:n]]
                if s == 0:
                    break
                # Each CTA's partial over its own dz columns, for every
                # unit; each unit's partials summed over the CTAs in order.
                new = torch.zeros((R, H))
                for c, (a, b) in enumerate(owned):
                    A = torch.zeros((R, K))
                    for gg in range(4):
                        A[:, gg * U:gg * U + b - a] = z[:, gg * H + a:
                                                        gg * H + b]
                    new = new + _ksum(A, Bs[c], ks)[:, :H]
                Dh = new
    return dz


# (B, H, C, rows): at the plan (C None), and at forced plans the emulation
# would not reach otherwise: 32 rows (two m16 tiles), C=2, C=4 with a
# short last CTA, C=8.
EMU_CASES = [(3, 7, None, None), (17, 33, None, None), (5, 201, None, None),
             (2, 1, None, None), (17, 33, None, 32), (5, 201, 2, None),
             (3, 7, 4, None), (4, 201, 8, 32)]


@pytest.mark.parametrize("B,H,C,rows", EMU_CASES)
def test_torch_chain16_emulation_matches_plain(B, H, C, rows):
    T = 9
    rng = np.random.RandomState(B * 1000 + H)
    lens = rng.randint(0, T + 1, B).astype(np.int32)
    lens[0], lens[-1] = 0, T
    g = rng.uniform(0.02, 0.98, (B, T, 2, 4 * H)).astype(np.float32)
    g[..., 3 * H:] = 2 * g[..., 3 * H:] - 1
    c = rng.uniform(-1, 1, (B, T, 2, H)).astype(np.float32)
    gy = rng.uniform(-1, 1, (B, T, 2 * H)).astype(np.float32)
    sc = min(0.3, 3.0 / H ** 0.5)
    wh = rng.uniform(-sc, sc, (2, H, 4 * H)).astype(np.float32)
    L = torch.from_numpy(lens)
    pad = torch.arange(T)[None, :] >= L[:, None]
    g, c, gy, wh = (torch.from_numpy(v) for v in (g, c, gy, wh))
    g[pad], c[pad], gy[pad] = 0.0, 0.0, 0.0
    c, gy = c.bfloat16(), gy.bfloat16()
    plan = bk.chain_cluster_plan(B, H, C=C, rows=rows)
    assert plan.C and plan.C == (C or plan.C)
    assert plan.rows == (rows or plan.rows)
    got = emulate_chain16(g, c, gy, wh, L, plan)
    ref = tlstm.bidi_lstm_bwd_chain_plain(g, c, gy, wh, L,
                                          xz_bf16=True).float()
    scale = float(ref.abs().max())
    assert scale > 0
    assert bool((got[pad] == 0).all())
    err = (got - ref).abs()
    assert float(err.max()) <= EMU_RTOL * scale, float(err.max()) / scale
    assert float(err.mean()) <= EMU_MEAN_RTOL * scale
    # The wrapper on a CPU tensor runs the plain version.
    cpu = bk.bidi_lstm_bwd_chain(g, c, gy, wh, L, xz_bf16=True)
    assert torch.equal(cpu.float(), ref)
