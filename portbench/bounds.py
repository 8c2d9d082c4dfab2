"""The yardstick's arithmetic: peaks, and the least time a kernel's work can
take on the card (its roofline bound). The pricing of one layer graph (its
layers, the matrix flop of a frame, the bounds of its layers' work a step)
lives in its family's file (registry.family), built from these.

Frozen copies, so that the benchmark's prices do not move when the program
does: ``bound`` and ``lstm_bound`` are those of the repository's
``chip_smoke.py`` after its recount of the valid frames (reads at the V
valid frames, writes at all B·T), and the CTC bounds those of its kernel
table (K5, K6). The price of a kind of work is the same whatever kernel
implements it, so that a later kernel that replaces another is held to the
same bound.

Everything here is arithmetic on shapes: no card is needed to evaluate it.
"""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (its
    torch.cuda.get_device_name()): the first entry of peaks.json whose
    ``match`` is a part of the name. Raises for a card the table lacks: a
    share of an unknown peak is not reported."""
    with open(PEAKS_FILE, encoding="utf-8") as f:
        table = json.load(f)
    for entry in table["cards"]:
        if entry["match"] in kind:
            return entry
    raise KeyError(f"no peaks for the card {kind!r} in {PEAKS_FILE}")


def _h100() -> dict:
    return peaks("H100")


def bound(flop: float, nbytes: float, peak_flops: float,
          hbm_bps: float) -> tuple:
    """(bound_ms, bound_by) for ``flop`` matrix flop at ``peak_flops`` and
    ``nbytes`` moved at ``hbm_bps``: the larger of the two times."""
    f_ms, b_ms = flop / peak_flops * 1e3, nbytes / hbm_bps * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def lstm_bound(kind: str, B, T, D, H, V, dx=False, esize=4, pk=None):
    """bound() of a bidi LSTM layer's work at [B, T] with V valid frames:
    the forward z = [x|1]·W_in + h·Wh ("fwd": inference, "fwd_state": with
    the gates and cell the backward reads), the same on a hoisted
    projection xz ("xz", "xz_state": h·Wh alone), the backward chain
    ("chain": Dh = dz·Whᵀ), or the contractions ("reduce": dW, and dx when
    asked). ``esize`` bytes for the streams and weights (4 f32, 2 bf16,
    whose products then run at the bf16 tensor cores' peak); the gates and
    dW are f32 in both. Streams read count at the V valid frames (a padded
    frame reads nothing), streams written at all B·T."""
    pk = pk or _h100()
    G, BT, e = 4 * H, B * T, esize
    peak = pk["f32_mma_flops"] if e == 4 else pk["bf16_flops"]
    hbm = pk["hbm_bytes_per_s"]

    def state(n):                               # gates and cell, n frames
        return n * 2 * (4 * G + e * H)
    if kind in ("fwd", "fwd_state"):
        flop = 2 * V * 2 * (D + 1 + H) * G
        nbytes = e * (V * D + 2 * (D + 1 + H) * G + BT * 2 * H) + 4 * B
    elif kind in ("xz", "xz_state"):
        flop = 2 * V * 2 * H * G
        nbytes = e * (V * 2 * G + 2 * H * G + BT * 2 * H) + 4 * B
    elif kind == "chain":
        return bound(2 * V * 2 * G * H,
                     state(V) + e * (V * 2 * H + 2 * H * G + BT * 2 * G)
                     + 4 * B, peak, hbm)
    elif kind == "reduce":
        flop = 2 * V * 2 * (D + 1 + H) * G + (V * 2 * 2 * G * D if dx else 0)
        nbytes = (e * (V * D + V * 2 * H + V * 2 * G
                       + (2 * D * G + BT * D if dx else 0))
                  + 4 * 2 * (D + 1 + H) * G)
    else:
        raise ValueError(f"unknown LSTM work {kind!r}")
    return bound(flop, nbytes + (state(BT) if kind.endswith("state") else 0),
                 peak, hbm)


def ctc_bound(kind: str, B, T, S, pk=None):
    """bound() of the alignment DP over [B, T, S] f32 lattices: the forward
    DP ("forward", K5: reads the match scores, writes log-alpha) or the
    fused second direction ("both", K6: reads the scores and log-alpha,
    writes both and its logsumexp over time). Bytes alone: the DP does no
    matrix work."""
    pk = pk or _h100()
    lat = 4 * B * T * S
    if kind == "forward":
        nbytes = 2 * lat + 4 * B
    elif kind == "both":
        nbytes = 3 * lat + 4 * B * S + 8 * B
    else:
        raise ValueError(f"unknown CTC work {kind!r}")
    return bound(0, nbytes, pk["bf16_flops"], pk["hbm_bytes_per_s"])


def hoists(D: int, H: int) -> bool:
    """Whether an LSTM layer's input projection is hoisted out of the
    recurrence (one product over all frames, then h·Wh alone): where its
    input, with its bias row, is wider than its hidden size rounded up to
    the lane width of 128. The benchmark's own statement of the layer plan
    it prices; the CPU tests hold it to the program's choice at the
    configured widths."""
    return D + 1 > -(-H // 128) * 128


def layers(cfg: dict) -> list:
    """The LSTM layers of a configuration as (D, H) pairs, input first, as
    its family prices them (scripts/torch_span_account.py reads them)."""
    from portbench import registry
    return registry.family(cfg).layers(cfg)


def ctc_step_bound_ms(B: int, T: int, S: int) -> float:
    """The bound of one training step's alignment DP (K5 then K6)."""
    return ctc_bound("forward", B, T, S)[0] + ctc_bound("both", B, T, S)[0]


# The bound functions of work that is the same in every layer graph: each
# prices one step's work from a step record (a dict with B, T, S, V and
# train) and the configuration. A family's file adds those of its own
# layers, and its own "ctc" where its alignment runs over other frames
# than the T of the input.
STEP_BOUNDS = {
    "ctc": lambda cfg, st: (ctc_step_bound_ms(st["B"], st["T"], st["S"])
                            if st["train"] else 0.0),
}


def step_bound(fam, name: str):
    """The bound function ``name`` (a kernel entry's ``bound``, or a
    reader's): the family's STEP_BOUNDS first, then the shared ones."""
    own = getattr(fam, "STEP_BOUNDS", {})
    if name in own:
        return own[name]
    if name in STEP_BOUNDS:
        return STEP_BOUNDS[name]
    raise KeyError(f"no bound function {name!r} in the family or "
                   "bounds.STEP_BOUNDS")
