"""OCR dataset pipeline: manifests, line preparation, width-bucketed batches
(port of clstm_tpu/data/dataset.py).

A manifest file lists PNG line images; transcripts live in sibling .gt.txt
files (the reference's clstmocrtrain layout). Line preparation matches the
ocropy/reference recipe (clstmhl.h ≈L120): invert (ink high),
measure+normalize, rescale to [0,1], transpose to time-major, pad blank
frames on both sides. Lines are grouped into the same geometric width
buckets as the JAX package, so both packages pad a page and batch a corpus
the same way; target state counts are bucketed alike.
"""

from __future__ import annotations

import bisect
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from clstm_tpu_torch.io.normalize import INormalizer, make_normalizer
from clstm_tpu_torch.io.png import read_png
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.ops.ctc import mktargets_ids
from clstm_tpu_torch.utils.text import read_text

# Geometric width buckets (frames, after padding); lines wider than the
# last bucket are truncated to it.
T_BUCKETS = (128, 192, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096)
# Target-state buckets (S = 2N+1 CTC states, padded up): S up to 512 covers
# transcripts up to 255 characters.
S_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)
# Finer width grid of the device-cache training path, used with groups
# merged over S (DeviceDataset merge_sb): the JAX package's measured
# default there (BASELINE.md:541-562).
T_BUCKETS_FINE = (128, 160, 192, 224, 256, 320, 384, 448, 512, 640, 768,
                  896, 1024, 1280, 1536, 2048, 3072, 4096)


def count_truncations(samples, codec: Codec,
                      t_buckets: Sequence[int] = T_BUCKETS,
                      s_buckets: Sequence[int] = S_BUCKETS):
    """-> (frames_truncated, targets_truncated): lines whose prepared width
    exceeds the largest T bucket (input frames cut by _emit's clamp) or
    whose blank-interleaved target exceeds the largest S bucket (the model
    trains toward a truncated transcript). The CLI prints
    truncation_report when either is nonzero."""
    t_over = s_over = 0
    for x, text in samples:
        if x.shape[0] > t_buckets[-1]:
            t_over += 1
        if 2 * len(codec.encode(text)) + 1 > s_buckets[-1]:
            s_over += 1
    return t_over, s_over


def truncation_report(t_over: int, s_over: int,
                      t_buckets: Sequence[int] = T_BUCKETS,
                      s_buckets: Sequence[int] = S_BUCKETS) -> str:
    parts = []
    if t_over:
        parts.append(f"{t_over} line(s) wider than {t_buckets[-1]} frames "
                     "(input truncated)")
    if s_over:
        parts.append(f"{s_over} transcript(s) longer than "
                     f"{(s_buckets[-1] - 1) // 2} chars (TARGET truncated "
                     "— trains toward the wrong string)")
    return "; ".join(parts)


def prepare_line(img: np.ndarray, normalizer: INormalizer,
                 pad: int = 16) -> np.ndarray:
    """Grayscale [h, w] in [0,1], ink-black-on-white -> model input [T, H]."""
    inv = img.max() - img if img.size else img
    normalizer.measure(inv)
    strip = normalizer.normalize(inv)            # [target_height, w']
    m = strip.max()
    if m > 0:
        strip = strip / m
    x = strip.T.astype(np.float32)               # [w', H]
    if pad > 0:
        x = np.pad(x, ((pad, pad), (0, 0)))
    return x


def bucket_for(value: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= value (last bucket if value exceeds all)."""
    i = bisect.bisect_left(buckets, value)
    return buckets[min(i, len(buckets) - 1)]


# The cost of one CTC lattice cell relative to one padded frame-row of the
# default bidi training step, for auto_t_cuts' lattice term: the CTC
# alignment's ms over (the step's ms x S) on the bench batch (B=256,
# T=1024, S=81), measured by chip_smoke.py phase 25 on an NVIDIA H100 80GB
# HBM3 at a 700.00 W power limit (1.559 ms of a 12.903 ms step). Read when
# auto_t_cuts is called.
AUTO_S_WEIGHT = 1.491e-3


def auto_t_cuts(lengths: Sequence[int], batch_size: int = 32,
                epochs: int = 64, k: int = 64,
                dispatch_penalty_rows: float = 0.0,
                quantum: int = 16, t_max: int = T_BUCKETS[-1],
                max_groups: int = 24,
                s_lengths: Optional[Sequence[int]] = None,
                s_weight: Optional[float] = None) -> tuple:
    """Corpus-adaptive T buckets: an exact DP over this corpus's length
    histogram instead of a fixed grid (``t_buckets=auto`` of
    clstmocrtrain).

    Cost model: a batch costs ~B*T executed frame-rows, so a group of n
    lines padded to bucket upper U over an E-epoch resident plan costs
    ``ceil(n*E/B) * B * U`` frame-rows, plus ``ceil(batches/k) *
    dispatch_penalty_rows`` for its K-batch block calls. The DP picks cut
    points over the (quantum-rounded) unique lengths minimizing the total,
    trading masked frames against partial-batch tails and block calls for
    the corpus's own mix.

    ``dispatch_penalty_rows`` is the overhead of one block call in
    frame-rows (seconds times frame-rows per second;
    device_cache.measure_dispatch_penalty_rows measures it when a
    DeviceDataset is built with ``t_buckets="auto"``). If the optimum
    exceeds ``max_groups`` groups (each a set of shapes the kernels and
    the caches meet), the penalty is doubled until it fits.

    ``s_lengths`` (per-line blank-interleaved target sizes 2*chars+1,
    aligned with ``lengths``) adds the CTC lattice term: with merged S
    buckets a group's S bucket is the largest of its lines', so a wide T
    group widens every member's [T, S] lattice. ``s_weight`` is the cost
    of one lattice cell relative to a frame-row (None: AUTO_S_WEIGHT);
    a group then costs ``batches * B * U * (1 + s_weight * S_group)``.

    The same arguments give the same cuts as the JAX package's
    auto_t_cuts; only the default ``s_weight`` is this card's."""
    if s_weight is None:
        s_weight = AUTO_S_WEIGHT
    lens = [min(int(v), t_max) for v in lengths if v > 0]
    if not lens:
        return (t_max,)
    svals = None
    if s_lengths is not None:
        svals = [int(s) for v, s in zip(lengths, s_lengths) if v > 0]
    rounded = sorted({min(t_max, -(-v // quantum) * quantum) for v in lens})
    C = len(rounded)
    counts = [0] * C
    smax = [0] * C
    for idx, v in enumerate(lens):
        pos = bisect.bisect_left(rounded,
                                 min(t_max, -(-v // quantum) * quantum))
        counts[pos] += 1
        if svals is not None:
            smax[pos] = max(smax[pos], bucket_for(svals[idx], S_BUCKETS))
    pref = [0]
    for c in counts:
        pref.append(pref[-1] + c)
    penalty = max(float(dispatch_penalty_rows), 0.0)
    while True:
        best = [float("inf")] * (C + 1)
        best[0] = 0.0
        arg = [-1] * (C + 1)
        for j in range(1, C + 1):
            U = rounded[j - 1]
            s_run = 0
            for i in range(j - 1, -1, -1):
                s_run = max(s_run, smax[i])   # max S over range [i, j)
                n = pref[j] - pref[i]
                if n == 0:
                    continue
                batches = -(-n * epochs // batch_size)
                row = U * (1.0 + s_weight * s_run) if svals is not None else U
                c = (best[i] + batches * batch_size * row
                     + -(-batches // max(k, 1)) * penalty)
                if c < best[j]:
                    best[j] = c
                    arg[j] = i
        cuts = []
        j = C
        while j > 0:
            cuts.append(rounded[j - 1])
            j = arg[j]
        if len(cuts) <= max_groups:
            return tuple(sorted(cuts))
        penalty = max(penalty * 2.0, float(batch_size * quantum))


class OcrDataset:
    """Manifest of PNG line images with .gt.txt transcripts."""

    def __init__(self, manifest: str, target_height: int = 48,
                 dewarp: str = "center", pad: int = 16):
        with open(manifest) as f:
            self.files = [ln.strip() for ln in f if ln.strip()]
        self.target_height = target_height
        self.dewarp = dewarp
        self.pad = pad

    def __len__(self) -> int:
        return len(self.files)

    def gt_path(self, i: int) -> str:
        base = self.files[i]
        for ext in (".png", ".jpg", ".jpeg", ".pgm", ".pbm"):
            if base.endswith(ext):
                base = base[: -len(ext)]
                break
        return base + ".gt.txt"

    def text(self, i: int) -> str:
        return read_text(self.gt_path(i))

    def texts(self) -> List[str]:
        return [self.text(i) for i in range(len(self))]

    def build_codec(self) -> Codec:
        return Codec.build(self.texts())

    def load(self, i: int) -> Tuple[np.ndarray, str]:
        """-> (prepared input [T, H], transcript)."""
        img = read_png(self.files[i])
        norm = make_normalizer(self.dewarp, self.target_height)
        return prepare_line(img, norm, self.pad), self.text(i)

    def load_all(self, nthreads: int = 0) -> List[Tuple[np.ndarray, str]]:
        """Load and prepare every line: through the native threaded decode
        and prepare (io/native.py PrefetchLoader, ``nthreads`` threads, 0 =
        one a core) where the native library builds, else on the host
        line by line (PIL decode, scipy normalization)."""
        from clstm_tpu_torch.io import native
        texts = self.texts()
        if native.available():
            with native.PrefetchLoader(self.files, self.target_height,
                                       pad=self.pad, dewarp=self.dewarp,
                                       nthreads=nthreads) as loader:
                return [(loader.get(i), texts[i]) for i in range(len(self))]
        return [(self.load(i)[0], texts[i]) for i in range(len(self))]


def make_batches(samples: Sequence[Tuple[np.ndarray, str]], codec: Codec,
                 batch_size: int,
                 t_buckets: Sequence[int] = T_BUCKETS,
                 s_buckets: Sequence[int] = S_BUCKETS,
                 rng: Optional[np.random.RandomState] = None,
                 drop_remainder: bool = False) -> Iterator[dict]:
    """Group prepared (x [T,H], text) samples into bucketed padded batches.

    Yields {"x": [B,Tb,H], "lengths": [B], "targets": [B,Sb],
    "target_lengths": [B], "texts": list[str]} with B <= batch_size and all
    rows in a batch sharing the same (Tb, Sb) bucket.
    """
    groups: dict = {}
    order = np.arange(len(samples))
    if rng is not None:
        rng.shuffle(order)
    for idx in order:
        x, text = samples[idx]
        classes = codec.encode(text)
        tb = bucket_for(x.shape[0], t_buckets)
        sb = bucket_for(2 * len(classes) + 1, s_buckets)
        groups.setdefault((tb, sb), []).append((x, text, classes))
        if len(groups[(tb, sb)]) == batch_size:
            yield _emit(groups.pop((tb, sb)), tb, sb)
    if not drop_remainder:
        for (tb, sb), items in groups.items():
            yield _emit(items, tb, sb)


def _emit(items: list, tb: int, sb: int) -> dict:
    B = len(items)
    H = items[0][0].shape[1]
    x = np.zeros((B, tb, H), np.float32)
    lengths = np.zeros(B, np.int32)
    targets = np.zeros((B, sb), np.int32)
    tlens = np.zeros(B, np.int32)
    texts = []
    for b, (xi, text, classes) in enumerate(items):
        T = min(xi.shape[0], tb)
        x[b, :T] = xi[:T]
        lengths[b] = T
        ids = mktargets_ids(classes)
        S = min(len(ids), sb)
        targets[b, :S] = ids[:S]
        tlens[b] = S
        texts.append(text)
    return {"x": x, "lengths": lengths, "targets": targets,
            "target_lengths": tlens, "texts": texts}


# Input-length buckets of the string-transduction path (frames after
# input_repeat): text inputs are short, so they start at 16.
TEXT_T_BUCKETS = (16, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def encode_onehot(ids: Sequence[int], ni: int, k: int = 1) -> np.ndarray:
    """Input ids -> one-hot frames [max(len*k, 1), ni], each id repeated
    ``k`` times (an empty input is one zero frame)."""
    x = np.zeros((max(len(ids) * k, 1), ni), np.float32)
    for t, c in enumerate(ids):
        x[t * k:(t + 1) * k, c] = 1.0
    return x


def make_text_batches(pairs, icodec: Codec, codec: Codec, batch_size: int,
                      t_buckets: Sequence[int] = TEXT_T_BUCKETS,
                      s_buckets: Sequence[int] = S_BUCKETS,
                      rng: Optional[np.random.RandomState] = None,
                      input_repeat: int = 1) -> Iterator[dict]:
    """Bucketed batches for string transduction (clstmfiltertrain): inputs
    one-hot through ``icodec`` (each frame repeated ``input_repeat``
    times), CTC targets through ``codec``. Same contract as make_batches."""
    ni = icodec.size()
    k = max(1, int(input_repeat))
    samples = [(encode_onehot(icodec.encode(a), ni, k), b) for a, b in pairs]
    yield from make_batches(samples, codec, batch_size,
                            t_buckets=t_buckets, s_buckets=s_buckets, rng=rng)


def pad_batch_rows(batch: dict, batch_size: int) -> dict:
    """Right-pad a short batch to ``batch_size`` rows (zero lengths mask the
    dummy rows out of loss and decode)."""
    B = len(batch["lengths"])
    if B == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        if k == "texts":
            out[k] = list(v) + [""] * (batch_size - B)
        else:
            pad = [(0, batch_size - B)] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, pad)
    return out
