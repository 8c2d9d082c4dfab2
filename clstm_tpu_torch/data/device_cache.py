"""Device-resident dataset cache: upload the corpus once, gather batches on
the device every epoch (port of clstm_tpu/data/device_cache.py).

The reference trains one line at a time from host memory (clstmocrtrain.cc
≈L100). OCR corpora are small, so each (T bucket, S bucket) group is stacked
into one set of tensors on the card, and every epoch's batches are gathered
there from a permuted index plan, itself one tensor per group on the card:
a batch costs no host-to-device copy. Epoch semantics (bucketed shapes,
right-padding, zero-row padding of remainder batches) are those of
data/dataset.py make_batches + pad_batch_rows, and the plans are drawn from
the caller's numpy RandomState exactly as the JAX package draws them, so the
same seed gives the same batches in both packages.

Each group carries one extra all-zero sentinel row (length 0, empty
targets); remainder batches pad with the sentinel index, and zero-length
rows are masked out of loss, gradients and decode everywhere.

With ``mesh`` (data parallelism, parallel/mesh.py) every rank holds the
whole corpus on its own device, as the JAX package replicates it, and draws
the same plans from a RandomState seeded alike; the parallel steps gather
each rank's own rows. A checksum of each epoch's plan and of the
RandomState is compared across the ranks (plan_guard), which raises if one
rank drew what the others did not.

``t_buckets="auto"`` groups by corpus-adaptive cuts (data/dataset.py
auto_t_cuts) instead of a fixed grid, with the cost of a block call
measured on the device (measure_dispatch_penalty_rows); under a mesh rank
0's measurement is broadcast, so every rank builds the same groups.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from clstm_tpu_torch.data.dataset import (
    S_BUCKETS, T_BUCKETS, TEXT_T_BUCKETS, auto_t_cuts, bucket_for)
from clstm_tpu_torch.io import native
from clstm_tpu_torch.io.png import read_png
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import _canon_dewarp
from clstm_tpu_torch.ops.ctc import mktargets_ids
from clstm_tpu_torch.ops.preprocess import (
    PREPARE_CHUNK, estimate_out_T, prepare_images)
from clstm_tpu_torch.parallel.mesh import plan_checksum, plan_guard
from clstm_tpu_torch.train import gather_batch
from clstm_tpu_torch.utils.config import to_device, torch_device
from clstm_tpu_torch.utils.profiling import span


# Padded frame-rows a second of the default bidi training step (B=256,
# T=1024 on the bench batch), which converts a block call's round trip into
# frame-rows for auto_t_cuts: measured by chip_smoke.py phase 25 on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit (256 x 1,024 rows in
# 12.903 ms). The environment variable ``bucket_dp_rows_per_sec`` overrides
# it (a bigger net's frame-row costs more). Read when
# measure_dispatch_penalty_rows is called.
AUTO_ROWS_PER_SEC = 2.032e7


def measure_dispatch_penalty_rows(device=None, reps: int = 5) -> float:
    """The overhead of one call to the device in auto_t_cuts' unit,
    frame-rows: the median round trip of a tiny op (``v + 1.0`` on an
    [8, 128] f32 tensor, then a synchronize of the device) over ``reps``
    after one warm-up, times AUTO_ROWS_PER_SEC (or
    ``$bucket_dp_rows_per_sec``). ``device`` None means the card.

    Unlike the JAX package, which takes 0.0 when its measurement fails, a
    failure here raises: the cuts are not solved for a device that was not
    measured."""
    rows_per_s = float(os.environ.get("bucket_dp_rows_per_sec",
                                      AUTO_ROWS_PER_SEC))
    dev = torch_device("cuda" if device is None else device)
    v = torch.zeros((8, 128), dtype=torch.float32, device=dev)

    def once() -> float:
        t0 = time.perf_counter()
        v.add(1.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    once()
    ts = sorted(once() for _ in range(reps))
    return ts[len(ts) // 2] * rows_per_s


def _resolve_t_buckets(t_buckets, lengths, auto_hints, device=None,
                       s_lengths=None, mesh=None):
    """``t_buckets="auto"`` -> corpus-adaptive DP cuts (auto_t_cuts) from
    the given per-line frame lengths (+ blank-interleaved target sizes for
    the CTC lattice term); anything else passes through.

    Under a mesh every rank must build the same groups (plan_guard), so
    rank 0's penalty (its hint or its measurement) is broadcast before any
    rank solves the DP: a rank's own measurement would give it other cuts.
    """
    if not (isinstance(t_buckets, str) and t_buckets == "auto"):
        return t_buckets
    hints = dict(auto_hints or {})
    if mesh is not None:
        penalty = (hints.get("dispatch_penalty_rows") if mesh.main
                   else None)
        if mesh.main and penalty is None:
            penalty = measure_dispatch_penalty_rows(device)
        t = torch.tensor([penalty or 0.0], dtype=torch.float64,
                         device=mesh.device)
        mesh.broadcast(t)
        hints["dispatch_penalty_rows"] = float(t[0])
    elif "dispatch_penalty_rows" not in hints:
        hints["dispatch_penalty_rows"] = measure_dispatch_penalty_rows(device)
    return auto_t_cuts(lengths, s_lengths=s_lengths, **hints)


def read_images(files: Sequence[str], nthreads: int = 0) -> list:
    """Decode line images in a thread pool -> float32 [h, w] arrays: with
    the native reader (io/native.py, libpng) where it builds, else PIL."""
    reader = native.read_png if native.available() else read_png
    nthreads = nthreads or min(16, max(4, (len(files) + 63) // 64))
    with ThreadPoolExecutor(nthreads) as pool:
        return list(pool.map(reader, files))


class DeviceDataset:
    """Bucket-grouped prepared samples resident on ``device``.

    samples: list of (x [T, H] float32, text) as produced by
    OcrDataset.load_all / prepare_line. Grouping and padding match
    make_batches exactly (same buckets, same truncation rules).
    ``merge_sb=True`` groups by T bucket only and pads every line in a
    group to the group's largest S bucket: fewer, larger groups, fewer
    partial batches. ``mesh``: the data-parallel group this rank's copy
    serves (its device must be ``device``), or None.

    ``t_buckets="auto"`` solves for corpus-adaptive cuts instead of a fixed
    grid (data/dataset.py auto_t_cuts); ``auto_hints`` passes the plan
    parameters of its cost model (batch_size, epochs, k: the CLI forwards
    its own) and optionally dispatch_penalty_rows, otherwise measured on
    ``device`` (measure_dispatch_penalty_rows; under a mesh, on rank 0).
    """

    def __init__(self, samples: Sequence[Tuple[np.ndarray, str]],
                 codec: Codec, t_buckets: Sequence[int] = T_BUCKETS,
                 s_buckets: Sequence[int] = S_BUCKETS, *, device,
                 merge_sb: bool = False, mesh=None,
                 auto_hints: Optional[dict] = None):
        self._place(device, mesh)
        t_buckets = _resolve_t_buckets(
            t_buckets, [x.shape[0] for x, _ in samples], auto_hints,
            self.device, [2 * len(codec.encode(t)) + 1 for _, t in samples],
            self.mesh)
        groups = self._group(
            [(x, text, x.shape[0]) for x, text in samples], codec,
            t_buckets, s_buckets, merge_sb)
        self.groups = []
        self.nbytes = 0
        for (tb, sb), items in sorted(groups.items()):
            N = len(items)
            H = items[0][0].shape[1]
            x = np.zeros((N + 1, tb, H), np.float32)     # +1 zero sentinel
            lengths = np.zeros(N + 1, np.int32)
            for i, (xi, _, _) in enumerate(items):
                T = min(xi.shape[0], tb)
                x[i, :T] = xi[:T]
                lengths[i] = T
            self.nbytes += x.nbytes
            self._add_group(tb, sb, items, to_device(x, self.device),
                            to_device(lengths, self.device), lengths)

    def _place(self, device, mesh) -> None:
        self.device = torch_device(device)
        self.mesh = mesh
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, corpus on "
                             f"{self.device}")

    def _group(self, items, codec: Codec, t_buckets, s_buckets,
               merge_sb: bool) -> dict:
        """(payload, text, width) items -> {(tb, sb): [(payload, text,
        classes)]}, counting over-bucket lines (count_truncations)."""
        groups: dict = {}
        self.t_truncated = self.s_truncated = 0
        for payload, text, width in items:
            classes = codec.encode(text)
            tb = bucket_for(width, t_buckets)
            sb = bucket_for(2 * len(classes) + 1, s_buckets)
            self.t_truncated += width > t_buckets[-1]
            self.s_truncated += 2 * len(classes) + 1 > s_buckets[-1]
            key = tb if merge_sb else (tb, sb)
            groups.setdefault(key, []).append((payload, text, classes, sb))
        if merge_sb:
            groups = {(tb, max(it[3] for it in members)): members
                      for tb, members in groups.items()}
        return {k: [it[:3] for it in v] for k, v in groups.items()}

    def _add_group(self, tb: int, sb: int, items, x: torch.Tensor,
                   lengths: torch.Tensor, host_lengths: np.ndarray) -> None:
        N = len(items)
        targets = np.zeros((N + 1, sb), np.int32)
        tlens = np.zeros(N + 1, np.int32)
        for i, (_, _, classes) in enumerate(items):
            ids = mktargets_ids(classes)
            S = min(len(ids), sb)
            targets[i, :S] = ids[:S]
            tlens[i] = S
        self.nbytes += targets.nbytes
        self.groups.append({
            "tb": tb, "sb": sb, "n": N, "texts": [it[1] for it in items],
            "x": x, "targets": to_device(targets, self.device),
            "lengths": lengths, "tlens": to_device(tlens, self.device),
            "host_lengths": host_lengths,
        })

    @classmethod
    def from_files(cls, files: Sequence[str], texts: Sequence[str],
                   codec: Codec, *, nthreads: int = 0,
                   **kw) -> "DeviceDataset":
        """Decode the line images (read_images) and build the cache from
        them with the normalization on the device (from_images, which
        takes the other arguments)."""
        return cls.from_images(read_images(files, nthreads), texts, codec,
                               **kw)

    @classmethod
    def from_images(cls, images: Sequence[np.ndarray], texts: Sequence[str],
                    codec: Codec, *, device, target_height: int = 48,
                    dewarp: str = "center", pad: int = 16,
                    t_buckets: Sequence[int] = T_BUCKETS,
                    s_buckets: Sequence[int] = S_BUCKETS,
                    chunk_size: int = PREPARE_CHUNK,
                    merge_sb: bool = False, mesh=None,
                    auto_hints: Optional[dict] = None) -> "DeviceDataset":
        """Build the cache directly from raw line images (float32 [h, w] in
        [0, 1], ink black on white), with the whole normalization and
        transposition running on the device (ops/preprocess.py
        prepare_images), ``chunk_size`` lines a call.

        Grouping uses the host-side width estimate (estimate_out_T's upper
        bound), since the exact normalized width is known only on the
        device; a line near a bucket edge may land one bucket higher than
        the host-prepared path puts it, with the same contents and length.
        ``t_buckets="auto"`` solves the cuts over those estimates.
        """
        kind = _canon_dewarp(dewarp)
        self = cls.__new__(cls)
        self._place(device, mesh)
        est_Ts = [estimate_out_T([raw], target_height, pad) for raw in images]
        t_buckets = _resolve_t_buckets(
            t_buckets, est_Ts, auto_hints, self.device,
            [2 * len(codec.encode(t)) + 1 for t in texts], self.mesh)
        groups = self._group(list(zip(images, texts, est_Ts)), codec,
                             t_buckets, s_buckets, merge_sb)
        self.groups = []
        self.nbytes = 0
        for (tb, sb), items in sorted(groups.items()):
            # Each chunk packed at its own size; PNG sources are
            # k/255-exact and go up as uint8 (a quarter of the bytes).
            x, lengths = prepare_images(
                [it[0] for it in items], self.device, kind=kind,
                target_height=target_height, out_T=tb, pad=pad,
                chunk_size=chunk_size)
            x_all = torch.cat([x, x.new_zeros((1, tb, target_height))])
            len_all = torch.cat([lengths, lengths.new_zeros((1,))])  # sentinel
            self.nbytes += x_all.numel() * 4
            self._add_group(tb, sb, items, x_all, len_all,
                            len_all.cpu().numpy())
        return self

    def __len__(self) -> int:
        return sum(g["n"] for g in self.groups)

    def epoch(self, batch_size: int,
              rng: Optional[np.random.RandomState] = None,
              drop_remainder: bool = False) -> Iterator[dict]:
        """Yield device batches covering every sample once.

        Each batch dict has device tensors x/lengths/targets/target_lengths
        ([B, Tb, H]/[B]/[B, Sb]/[B]) plus host-side "texts" (real rows only)
        and "host_lengths" [B] for reporting and decode. Rows beyond
        len(texts) are zero-length sentinel padding.
        """
        for p in self._epoch_seq(batch_size, rng, drop_remainder):
            g = p[0]
            chunk = p[1][p[4]]
            p[4] += 1
            batch = gather_batch(g, p[2][p[3]])
            p[3] += 1
            nreal = int(np.sum(chunk < g["n"]))
            yield dict(batch, texts=[g["texts"][i] for i in chunk[:nreal]],
                       host_lengths=g["host_lengths"][chunk])

    def _epoch_plans(self, batch_size: int, rng, drop_remainder: bool,
                     epochs: int = 1):
        """Per-group epoch plans shared by epoch()/epoch_refs()/
        epoch_blocks().

        Each group's plan is ``epochs`` independently shuffled epochs
        concatenated and chunked into batches (so batches and K-batch
        blocks span epoch boundaries and each group pays one partial,
        sentinel-padded batch per plan), uploaded to the device in one
        copy. Entries are mutable: [group, chunks [nb, B] host, the same on
        the device, j (the next batch the device steps take), used (the
        next batch the host hands out)]; consumers advance ``used`` and
        write the steps' returned counter back into slot 3."""
        with span("clstm.plan"):
            plans = []
            for g in self.groups:
                orders = []
                for _ in range(epochs):
                    order = np.arange(g["n"])
                    if rng is not None:
                        rng.shuffle(order)
                    orders.append(order)
                order = np.concatenate(orders)
                chunks = []
                for lo in range(0, len(order), batch_size):
                    chunk = order[lo:lo + batch_size]
                    if len(chunk) < batch_size:
                        if drop_remainder:
                            continue
                        pad = np.full(batch_size - len(chunk), g["n"],
                                      np.int64)
                        chunk = np.concatenate([chunk, pad])
                    chunks.append(chunk)
                if chunks:
                    idx_all = np.stack(chunks).astype(np.int64)
                    plans.append([g, idx_all, to_device(idx_all, self.device),
                                  0, 0])
            return plans

    def _epoch_seq(self, batch_size: int, rng, drop_remainder: bool):
        """Batch-granularity plan sequence (one entry per batch); each
        occurrence of a plan consumes its next chunk."""
        plans = self._epoch_plans(batch_size, rng, drop_remainder)
        seq = [p for p in plans for _ in range(len(p[1]))]
        if rng is not None:
            rng.shuffle(seq)
        self._guard(plans, [(p, 1) for p in seq], rng)
        return seq

    def _guard(self, plans, seq, rng) -> None:
        """Under a mesh, raise on every rank unless every rank drew this
        epoch's plans and order (plan_guard)."""
        if self.mesh is None:
            return
        at = {id(p): i for i, p in enumerate(plans)}
        order = np.array([(at[id(p)], kk) for p, kk in seq], np.int64)
        plan_guard(plan_checksum([p[1] for p in plans] + [order], rng),
                   self.mesh)

    def epoch_refs(self, batch_size: int,
                   rng: Optional[np.random.RandomState] = None,
                   drop_remainder: bool = False) -> Iterator[dict]:
        """Like epoch(), but yields batch REFERENCES for the gather+train
        step (train.make_cached_train_step): the resident group dict, the
        plan on the device and the batch counter, plus host-side
        texts/host_lengths. The consumer writes the step's returned counter
        back via ``batch["set_j"](new_j)`` before the plan's next batch.
        Same rng consumption as epoch(): the same batch sequence for the
        same seed."""
        for p in self._epoch_seq(batch_size, rng, drop_remainder):
            g = p[0]
            chunk = p[1][p[4]]
            p[4] += 1
            nreal = int(np.sum(chunk < g["n"]))

            def set_j(new_j, p=p):
                p[3] = new_j

            yield {
                "group": g, "idx_all": p[2], "j": p[3], "set_j": set_j,
                "texts": [g["texts"][i] for i in chunk[:nreal]],
                "host_lengths": g["host_lengths"][chunk],
            }

    def epoch_blocks(self, batch_size: int, k: int,
                     rng: Optional[np.random.RandomState] = None,
                     drop_remainder: bool = False,
                     epochs: int = 1) -> Iterator[dict]:
        """Like epoch_refs(), but yields K-batch BLOCK references for the
        multi-step call (train.make_multi_train_step): each block covers
        ``k`` consecutive batches of one group's plan (a group's trailing
        remainder yields one short block). Shuffling is at block
        granularity, so k>1 trains a different, equally valid epoch order
        than k=1 for the same seed. ``epochs`` > 1 builds each group's plan
        over that many epochs (see _epoch_plans).

        Block dict: group/idx_all/j/set_j as epoch_refs, plus
          exhaust     called by a caller that ran fewer than k batches:
                      the plan's later blocks are then skipped
          k           batches in this block
          nreal       real (non-sentinel) rows across the block
          nreal_per   [k] real rows per batch
          texts       [k] lists of per-batch real-row transcripts
          host_lengths[k] arrays of per-batch lengths
        """
        plans = self._epoch_plans(batch_size, rng, drop_remainder,
                                  epochs=epochs)
        seq = []
        for p in plans:
            nfull, rem = divmod(len(p[1]), k)
            seq += [(p, k)] * nfull
            if rem:
                seq.append((p, rem))
        if rng is not None:
            rng.shuffle(seq)
        self._guard(plans, seq, rng)
        for p, kk in seq:
            if p[4] >= len(p[1]):
                # Exhausted by a clamped (nvalid < k) block: the device
                # counter stopped mid-block, so later blocks of this plan
                # would retrain or skip plan regions.
                continue
            g = p[0]
            chunks = p[1][p[4]:p[4] + kk]
            p[4] += kk
            nreal_per = [int(np.sum(c < g["n"])) for c in chunks]

            def set_j(new_j, p=p):
                p[3] = new_j

            def exhaust(p=p):
                p[4] = len(p[1])

            yield {
                "group": g, "idx_all": p[2], "j": p[3], "set_j": set_j,
                "exhaust": exhaust,
                "k": kk, "nreal": sum(nreal_per), "nreal_per": nreal_per,
                "texts": [[g["texts"][i] for i in c[:n]]
                          for c, n in zip(chunks, nreal_per)],
                "host_lengths": [g["host_lengths"][c] for c in chunks],
            }


class TextDeviceDataset(DeviceDataset):
    """Device-resident string-transduction corpus (clstmfiltertrain).

    Each (T bucket, S bucket) group holds its inputs as int32 character ids
    [N+1, Tb] (4 bytes a frame, not 4·ni for a one-hot frame); the train
    steps expand the gathered ids to one-hot [B, T, ni] on the device
    (``input_onehot`` of train.make_cached_train_step and
    make_multi_train_step, which the group's ``onehot`` key selects in
    models/hl.py). Padding frames and the sentinel row hold id -1, which
    expands to an all-zero frame: the host path's zero padding
    (make_text_batches). Epoch plans, blocks and counters are
    DeviceDataset's.

    ``input_repeat`` repeats each input id k times along T (CLSTMText).
    Buckets and truncation as make_text_batches: inputs clamp at
    t_buckets[-1], blank-interleaved targets at s_buckets[-1], both
    counted (t_truncated, s_truncated). Batches carry int ids in ``x``:
    they feed the training steps, not predict_batch.
    """

    def __init__(self, pairs: Sequence[Tuple[str, str]], icodec: Codec,
                 codec: Codec, *, input_repeat: int = 1,
                 t_buckets: Sequence[int] = TEXT_T_BUCKETS,
                 s_buckets: Sequence[int] = S_BUCKETS, device, mesh=None):
        self._place(device, mesh)
        k = max(1, int(input_repeat))
        ni = icodec.size()
        ids_of = [icodec.encode(a) for a, _ in pairs]
        groups = self._group(
            [(ids, b, max(len(ids) * k, 1))   # empty input: one zero frame
             for ids, (_, b) in zip(ids_of, pairs)], codec, t_buckets,
            s_buckets, merge_sb=False)
        self.groups = []
        self.nbytes = 0
        for (tb, sb), items in sorted(groups.items()):
            N = len(items)
            x = np.full((N + 1, tb), -1, np.int32)       # -1: zero frame
            lengths = np.zeros(N + 1, np.int32)
            for i, (ids, _, _) in enumerate(items):
                lengths[i] = min(max(len(ids) * k, 1), tb)
                for t, c in enumerate(ids):
                    x[i, t * k:min((t + 1) * k, tb)] = c
            self.nbytes += x.nbytes
            self._add_group(tb, sb, items, to_device(x, self.device),
                            to_device(lengths, self.device), lengths)
            self.groups[-1]["onehot"] = ni

