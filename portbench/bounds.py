"""The yardstick's arithmetic: peaks, the least time a kernel's work can take
on the card (its roofline bound), and the matrix flop of a step.

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
    """Whether a bidi layer's input projection is hoisted out of the
    recurrence (one product over all frames, then h·Wh alone): where its
    input, with its bias row, is wider than its hidden size rounded up to
    the lane width of 128. The benchmark's own statement of the layer plan
    it prices; the CPU tests hold it to the program's choice at the
    configured widths."""
    return D + 1 > -(-H // 128) * 128


def layers(cfg: dict) -> list:
    """The bidi layers of a configuration as (D, H) pairs, input first."""
    D, out = cfg["ninput"], []
    for H in cfg["nhidden_layers"]:
        out.append((D, H))
        D = 2 * H
    return out


def flop_per_frame(cfg: dict, train: bool) -> int:
    """Matrix flop a valid frame costs: per bidi layer 2·4H(D+1+H) for each
    direction's z, plus the softmax's C(2H+1), times 2 for a multiply-add;
    a training step is three times its forward (forward, and the two
    products of the backward)."""
    per = sum(2 * 4 * H * (D + 1 + H) for D, H in layers(cfg))
    per += cfg["noutput"] * (2 * cfg["nhidden_layers"][-1] + 1)
    return (3 if train else 1) * 2 * per


def lstm_step_bound_ms(cfg: dict, B: int, T: int, V: int,
                       train: bool) -> float:
    """The bound of one step's LSTM work, summed over the layers: in
    training the forward with state (K1, or K4 on a hoisted projection),
    the chain and the contractions (dx from the second layer on, whose
    input is a layer's output); in serving the forward alone."""
    e = 2 if cfg["precision"] == "bf16" else 4
    total = 0.0
    for i, (D, H) in enumerate(layers(cfg)):
        fwd = "xz" if hoists(D, H) else "fwd"
        if not train:
            total += lstm_bound(fwd, B, T, D, H, V, esize=e)[0]
            continue
        total += lstm_bound(fwd + "_state", B, T, D, H, V, esize=e)[0]
        total += lstm_bound("chain", B, T, D, H, V, esize=e)[0]
        total += lstm_bound("reduce", B, T, D, H, V, dx=i > 0, esize=e)[0]
    return total


def ctc_step_bound_ms(B: int, T: int, S: int) -> float:
    """The bound of one training step's alignment DP (K5 then K6)."""
    return ctc_bound("forward", B, T, S)[0] + ctc_bound("both", B, T, S)[0]


# The bound functions a kernel entry (portbench/kernels/*.json) can name:
# each prices one step's work of its layer from a step record (a dict with
# B, T, S, V and train) and the configuration.
STEP_BOUNDS = {
    "lstm": lambda cfg, st: lstm_step_bound_ms(cfg, st["B"], st["T"],
                                               st["V"], st["train"]),
    "ctc": lambda cfg, st: (ctc_step_bound_ms(st["B"], st["T"], st["S"])
                            if st["train"] else 0.0),
}
