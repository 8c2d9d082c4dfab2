"""The CTC DP kernels' plan and lane mapping (csrc/ctc_dp.cu, K5, K6 and
K6b), on CPU.

The kernels cannot run here, so what surrounds them is held here instead:
``ctc_dp_plan`` at every S bucket and at widths across its branches (every
state owned by exactly one lane, every warp owning one, the threads,
registers and shared memory within a block's), and a torch emulation of
the DP computed the way the kernels compute it: each lane's run of
contiguous states, frames fetched ``prefetch`` ahead into a ring of slots,
the shift by one state as a shuffle inside each warp with the edge state
handed across warps, the boundary column in whatever lane holds it, NEG
past the last state, and K6's running pair started at its closed form for
the padded frames (the wide branch, past 2,048 states, as one state a
thread read at its frame). The emulation must equal the plain versions within
1e-6 relative, on rows of length 0 and T and target lengths from 1 to S.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.data.dataset import S_BUCKETS  # noqa: E402
from clstm_tpu_torch.ops import ctc as tctc  # noqa: E402
from clstm_tpu_torch.ops import ctc_kernel as ck  # noqa: E402

# The f32 lattice reaches |values| of a few hundred here; the emulation's
# logaddexp (max + log1p(exp(min - max)), as the kernels) and torch's
# differ by an ulp or two a step: 1e-6 of max(1, |plain|) holds the whole
# lattice and catches any wrong lane, shift, slot or boundary (1e-2 or
# more).
EMU_RTOL = 1e-6
NEG = float(np.float32(tctc.NEG))


def _owners(p, S):
    """(warp, lane, k) of every state s < S by the kernels' map."""
    out = {}
    for w in range(p.warps):
        for lane in range(32):
            for k in range(p.states):
                s = (w * 32 + lane) * p.states + k
                if s < S:
                    out.setdefault(s, []).append((w, lane, k))
    return out


@pytest.mark.parametrize("B", [1, 37, 256])
@pytest.mark.parametrize(
    "S", sorted(set(S_BUCKETS) | {1, 13, 31, 32, 33, 81, 513, 1025}))
def test_torch_ctc_plan_covers_and_fits(B, S):
    p = ck.ctc_dp_plan(B, S)
    assert p.states in ck.CTC_STATES
    assert p.prefetch == ck.CTC_PREFETCH[p.states]
    owners = _owners(p, S)
    assert sorted(owners) == list(range(S))
    assert all(len(v) == 1 for v in owners.values())
    # Every warp of a row owns a state; the lanes cover S.
    assert (p.warps - 1) * 32 * p.states < S <= p.warps * 32 * p.states
    assert 1 <= p.warps <= ck.ctc_max_warps(p.states) <= ck.CTC_MAX_WARPS
    # A block: one row, its threads within the kernels' launch bounds (and
    # so its registers within the block's), its shared memory within a
    # block's, K5's and K6b's (one ring) below K6's (two).
    assert p.threads == 32 * p.warps and p.blocks == B
    assert p.smem == ck.ctc_smem(S, p.warps, p.states, p.prefetch)
    assert p.smem <= ck.CTC_SMEM_MAX
    assert ck.ctc_dp_plan(B, S, both=False).smem < p.smem
    # The fewest states a lane: one fewer would need more warps.
    smaller = [k for k in ck.CTC_STATES if k < p.states]
    assert all(-(-S // (32 * k)) > ck.ctc_max_warps(k) for k in smaller)


@pytest.mark.parametrize("S,want", [(81, (3, 1, 16)), (32, (1, 1, 16)),
                                    (256, (8, 1, 16)),
                                    (512, (8, 2, 8)),
                                    (1025, (17, 2, 8)),
                                    (2049, (32, 0, 0)),
                                    (8192, (32, 0, 0)),
                                    (2048, (32, 2, 8)),
                                    (14528, (32, 0, 0))])
def test_torch_ctc_plan_branches(S, want):
    """The bench shape (S=81) takes three warps of one state a lane; wider
    rows two states a lane, and rows past 2,048 states the wide branch."""
    assert tuple(ck.ctc_dp_plan(256, S)[:3]) == want


@pytest.mark.parametrize("B", [4225, 5000, 100_000, 1_000_000])
def test_torch_ctc_plan_one_row_a_block(B):
    """However many rows, each takes a block of its own (the grid's x
    dimension holds 2**31 - 1 blocks)."""
    for S in (16, 81, 4097):
        p = ck.ctc_dp_plan(B, S)
        assert p.blocks == B and p.threads == 32 * p.warps
        assert p.threads <= 32 * ck.CTC_MAX_WARPS
        assert p.smem <= ck.CTC_SMEM_MAX


@pytest.mark.parametrize("S,both", [(2049, True), (14528, True),
                                    (14529, False), (29056, False)])
def test_torch_ctc_plan_wide_branch(S, both):
    """Past CTC_REG_S_MAX the states move to shared memory: 4·S floats a
    block in K6, 2·S in K5 and K6b, up to the block's shared memory."""
    assert S > ck.CTC_REG_S_MAX
    p = ck.ctc_dp_plan(3, S, both)
    assert (p.warps, p.states, p.prefetch) == (ck.CTC_MAX_WARPS, 0, 0)
    assert p.smem == 4 * (4 if both else 2) * S <= ck.CTC_SMEM_MAX


@pytest.mark.parametrize("B,S", [(0, 8), (4, 0), (4, 14529)])
def test_torch_ctc_plan_rejects(B, S):
    with pytest.raises(ValueError):
        ck.ctc_dp_plan(B, S)


def test_torch_ctc_plan_rejects_past_k5_shared_memory():
    with pytest.raises(ValueError):
        ck.ctc_dp_plan(4, 29057, both=False)


def test_torch_ctc_config_check():
    """The library's report of how it was built (clstm_ctc_config) must be
    what the plan assumes; anything else raises before a launch."""
    good = [ck.CTC_MAX_WARPS, ck.CTC_SMEM_MAX]
    for k, p in ck.CTC_PREFETCH.items():
        good += [k, p]
    ck.check_config(good)
    for bad in (good[:-2], good + [4, 4], [16] + good[1:],
                good[:3] + [good[3] * 2] + good[4:]):
        with pytest.raises(RuntimeError):
            ck.check_config(bad)


def _logaddexp(a, b):
    """The kernels' logaddexp: max + log1p(exp(min - max))."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(torch.minimum(a, b) - m))


class _Lanes:
    """A plan's lane map for S states: s[g, k] = g·K + k for the 32·W
    lanes g of a row, and the state each reads (the last one past S)."""

    def __init__(self, p, S):
        self.W, self.K, self.P = p.warps, p.states, p.prefetch
        if p.states == 0:
            # The wide branch: a thread a state (strided over the block's
            # threads, which moves no value), each frame read at its step.
            self.W, self.K, self.P = -(-S // 32), 1, 1
        self.NL = 32 * self.W
        self.s = (torch.arange(self.NL)[:, None] * self.K
                  + torch.arange(self.K)[None, :])
        self.off = self.s.clamp(max=S - 1)
        self.S = S

    def fetch(self, x, frames):
        """The slot a ring gets for per-row frames [B] of x [B, T, S]."""
        B = x.shape[0]
        return x[torch.arange(B)[:, None, None], frames[:, None, None],
                 self.off[None]]

    def shfl_up_with_edges(self, last, boundary):
        """w for each lane's first state: the lane before's last state by
        a shuffle inside each warp, a warp's lane 0 from the warp before
        (the edge exchange), state 0 the boundary."""
        B = last.shape[0]
        x = last.view(B, self.W, 32)
        e = torch.cat([x[..., :1], x[..., :-1]], -1)   # lane 0 keeps its own
        e[:, 1:, 0] = x[:, :-1, 31]
        e = e.reshape(B, self.NL)
        e[:, 0] = boundary
        return e

    def shfl_down_with_edges(self, first):
        """w for each lane's last state: the lane after's first state, a
        warp's lane 31 from the warp after (the last warp's keeps its own,
        past every state)."""
        B = first.shape[0]
        x = first.view(B, self.W, 32)
        e = torch.cat([x[..., 1:], x[..., -1:]], -1)
        e[:, :-1, 31] = x[:, 1:, 0]
        return e.reshape(B, self.NL)

    def states(self, v):
        """[B, NL, K] -> [B, S]: the real states."""
        return v.reshape(v.shape[0], -1)[:, :self.S]


def _emulate_forward(lm, lengths, p, skip=tctc.SKIP):
    """K5 as the kernel runs it -> lr [B, T, S]."""
    B, T, S = lm.shape
    ln = _Lanes(p, S)
    L = lengths.long().clamp(0, T)
    v = (skip * ln.s.float())[None].expand(B, -1, -1).clone()
    ring = [None] * ln.P
    for f in range(ln.P - 1):
        ring[f % ln.P] = ln.fetch(lm, torch.full((B,), min(f, T - 1)))
    out = torch.empty_like(lm)
    for t in range(T):
        f = t + ln.P - 1
        ring[f % ln.P] = ln.fetch(lm, torch.full((B,), min(f, T - 1)))
        lt = ring[t % ln.P]
        e = ln.shfl_up_with_edges(v[:, :, -1], skip * float(t))
        w = torch.cat([e[..., None], v[..., :-1]], -1)
        nv = _logaddexp(v + lt, w + lt)
        v = torch.where((t < L)[:, None, None], nv, v)
        out[:, t] = ln.states(v)     # frames t >= len: the carried state
    return out


def _emulate_both(lm, lr, lengths, tlens, p, both, skip=tctc.SKIP):
    """K6 (``both``: both [B, T, S], lse [B, S]) or K6b (rl [B, T, S]; lr
    None) as the kernel runs them: step i runs frame len-1-i of each
    row."""
    B, T, S = lm.shape
    ln = _Lanes(p, S)
    L = lengths.long().clamp(0, T)
    TL = tlens.long()[:, None, None]
    s = ln.s[None]
    u0 = torch.where(s < TL, skip * (TL - 1 - s).float(), torch.tensor(NEG))
    u = u0.expand(B, -1, -1).clone()
    past_last = s + 1 >= S
    bcol = s == TL - 1
    # The pair's closed form for frames len..T-1 (both = NEG there).
    m = torch.full_like(u, NEG)
    a = (T - L).float()[:, None, None].expand(B, ln.NL, ln.K).clone()
    ring, ringr = [None] * ln.P, [None] * ln.P

    def frames(j):
        return (L - 1 - j).clamp(min=0)

    def fetch(j):
        ring[j % ln.P] = ln.fetch(lm, frames(j))
        if both:
            ringr[j % ln.P] = ln.fetch(lr, frames(j))

    for j in range(ln.P - 1):
        fetch(j)
    out = torch.empty_like(lm)
    rows = torch.arange(B)
    for i in range(T):
        fetch(i + ln.P - 1)
        li, ri = ring[i % ln.P], ringr[i % ln.P]
        e = ln.shfl_down_with_edges(u[:, :, 0])
        w = torch.cat([u[..., 1:], e[..., None]], -1)
        w = torch.where(past_last, torch.tensor(NEG), w)
        w = torch.where(bcol, torch.tensor(skip * float(i)), w)
        act = (i < L)[:, None, None]
        u = torch.where(act, _logaddexp(u + li, w + li), u)
        bo = ri + u if both else u
        if both:
            hi = torch.maximum(m, bo)
            x = torch.exp(torch.minimum(m, bo) - hi)
            an = torch.where(bo > m, a * x + 1.0, a + x)
            a = torch.where(act, an, a)
            m = torch.where(act, hi, m)
        on = (i < L)
        out[rows[on], (L - 1 - i)[on]] = ln.states(bo)[on]
    pad = torch.arange(T)[None, :] >= L[:, None]
    if both:
        out[pad] = NEG
        lse = ln.states(m + torch.log(torch.clamp(a, min=1e-30)))
        return out, lse
    out[pad] = ln.states(u0.expand(B, -1, -1))[:, None, :].expand(
        B, T, S)[pad]
    return out


def _lattice(B, T, S, seed):
    """lmatch [B, T, S] (NEG beyond each row's target length), lengths with
    rows of length 0 and T, target lengths from 1 to S."""
    rng = np.random.RandomState(seed)
    lm = np.log(rng.rand(B, T, S).astype(np.float32) + 1e-3)
    lengths = rng.randint(0, T + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = T, 0
    tlens = rng.randint(1, S + 1, B).astype(np.int32)
    tlens[0], tlens[-1] = S, 1
    for b in range(B):
        lm[b, :, tlens[b]:] = NEG
    return tuple(torch.from_numpy(x) for x in (lm, lengths, tlens))


def _close(got, want, mask):
    d = (got - want).abs()[mask]
    return float((d / want.abs()[mask].clamp(min=1.0)).max()) <= EMU_RTOL


# (B, T, S, plan or None for ctc_dp_plan's): one warp a row, several warps
# of one state a lane (the bench's S=81), two states a lane, the wide
# branch (S = 2049, 4097), T below the frames in flight, the boundary column
# in lanes of every warp; and plans ctc_dp_plan does not pick but the
# kernels take (two warps of two and one warp of three at S=81).
EMU_CASES = [
    (5, 12, 1, None), (5, 12, 13, None), (4, 10, 32, None),
    (5, 12, 33, None), (6, 20, 81, None), (4, 9, 300, None),
    (3, 7, 513, None), (2, 6, 1025, None), (3, 3, 81, None),
    (2, 5, 2049, None), (2, 4, 4097, None),
    (4, 10, 81, (2, 2, 8)), (4, 10, 81, (1, 3, 8)),
    (3, 8, 512, (16, 1, 16)),
]


def _plan(B, S, forced):
    if forced is None:
        return ck.ctc_dp_plan(B, S)
    W, K, P = forced
    return ck.CtcPlan(W, K, P, 32 * W, B, ck.ctc_smem(S, W, K, P))


@pytest.mark.parametrize("B,T,S,forced", EMU_CASES)
def test_torch_ctc_emulated_forward_matches_plain(B, T, S, forced):
    lm, lengths, tlens = _lattice(B, T, S, seed=B * 7 + S)
    got = _emulate_forward(lm, lengths, _plan(B, S, forced))
    want = tctc.ctc_forward_plain(lm, lengths)
    L = lengths.long()
    valid = (torch.arange(T)[None, :] < L[:, None])[:, :, None] & (
        torch.arange(S)[None, None, :] < tlens.long()[:, None, None])
    assert _close(got, want, valid)
    # Frames t >= len carry the last state (the initial one at len 0).
    for b in range(B):
        last = got[b, L[b] - 1] if L[b] else tctc.SKIP * torch.arange(S)
        assert torch.equal(got[b, L[b]:], last.expand(T - L[b], S))


@pytest.mark.parametrize("B,T,S,forced", EMU_CASES)
def test_torch_ctc_emulated_both_matches_plain(B, T, S, forced):
    lm, lengths, tlens = _lattice(B, T, S, seed=B * 11 + S)
    lr = tctc.ctc_forward_plain(lm, lengths)
    got, lse = _emulate_both(lm, lr, lengths, tlens, _plan(B, S, forced),
                             both=True)
    want, want_lse = tctc.ctc_both_plain(lm, lr, lengths, tlens)
    L, TL = lengths.long(), tlens.long()
    pad = torch.arange(T)[None, :] >= L[:, None]
    sv = torch.arange(S)[None, :] < TL[:, None]
    assert _close(got, want, (~pad)[:, :, None] & sv[:, None, :])
    assert _close(lse, want_lse, sv & (L[:, None] > 0))
    assert (got[pad] == NEG).all()


@pytest.mark.parametrize("B,T,S,forced", EMU_CASES)
def test_torch_ctc_emulated_backward_matches_plain(B, T, S, forced):
    lm, lengths, tlens = _lattice(B, T, S, seed=B * 13 + S)
    got = _emulate_both(lm, None, lengths, tlens, _plan(B, S, forced),
                        both=False)
    want = tctc.ctc_backward_plain(lm, lengths, tlens)
    L, TL = lengths.long(), tlens.long()
    pad = torch.arange(T)[None, :] >= L[:, None]
    sv = torch.arange(S)[None, :] < TL[:, None]
    assert _close(got, want, (~pad)[:, :, None] & sv[:, None, :])
    # Frames t >= len hold the initial state.
    col = torch.arange(S)[None, :]
    u0 = torch.where(sv, tctc.SKIP * (TL[:, None] - 1 - col).float(),
                     torch.tensor(NEG))
    assert torch.equal(got[pad], u0[:, None, :].expand(B, T, S)[pad])


def test_torch_ctc_pair_closed_form():
    """The running pair's start for len..T-1 frames of both = NEG, m = NEG
    and a = T - len, is what the update gives frame by frame (f32)."""
    for n in (0, 1, 7, 124, 4096):
        m = torch.tensor(NEG)
        a = torch.tensor(0.0)
        for _ in range(n):
            m2 = torch.maximum(m, torch.tensor(NEG))
            a = a * torch.exp(m - m2) + torch.exp(torch.tensor(NEG) - m2)
            m = m2
        assert m == NEG and a == float(n)
