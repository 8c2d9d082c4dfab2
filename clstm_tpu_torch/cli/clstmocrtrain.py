"""clstmocrtrain — OCR training CLI (port of clstm_tpu/cli/clstmocrtrain.py).

Reference: clstmocrtrain.cc (≈L1-250, unverified). Usage:
  python -m clstm_tpu_torch.cli.clstmocrtrain TRAIN.files [TEST.files]
A manifest lists PNG line images with sibling .gt.txt transcripts. Env
params, with the JAX package's names and defaults:
  save_name=model    checkpoint basename (.clstm appended)
  load=              resume from a .clstm checkpoint (and its .state.npz)
  ntrain=1000000     number of training lines (trials)
  lrate=1e-4         learning rate
  momentum=0.9
  nhidden=100        hidden units per direction
  report_every=100   print truth/pred lines
  save_every=1000    periodic checkpoint (save_name-last.clstm)
  test_every=10000   evaluate test-set CER, keep the best model
  target_height=48   line normalization height
  dewarp=center      normalizer kind (center/mean/none)
  randseed=0         weight init and epoch shuffles
  batch_size=32      lines per batch
  net=bidi           prefab kind (bidi/bidi2/lstm1/.../vgsl)
  vgsl=              a VGSL spec string, the net of net=vgsl (implies it),
                     e.g. Tesseract's eng recogniser with target_height=36:
                     "[1,36,0,1 Ct3,3,16 Mp3,3 Lfys64 Lfx96 Lrx96 Lfx512
                     O1c1]" (models/prefab.py vgsl_net)
  log_jsonl=         path for structured JSONL metrics
  display_every=0    >0 writes the dashboard save_name-display.png (losses
                     and test CER, utils/display.py; matplotlib, else
                     nothing) every N trials, from the deferred reports
  gradient_clip=0    >0 enables global-norm clipping
  normalization=none lr normalization (none/len/batch)
  initial=0          weight init scale (0 = the prefab's default)
  augment=0          >0 enables on-device train-time augmentation
                     (ops/preprocess.py augment_lines)
  device=cuda        torch device; if CUDA is asked for and absent, this
                     raises rather than running on the CPU
  device_preprocess=0  build the device corpus cache straight from the raw
                     images, the normalization on the device
                     (DeviceDataset.from_files); implies cache=device
  steps_per_dispatch=0  K training batches per call over the device plan
                     (train.make_multi_train_step); 0 = auto (K <= 64,
                     clamped so save/test cadences overshoot by at most
                     ~one period). K>1 shuffles the epoch at block
                     granularity: another order than K=1 for the same seed
  t_buckets=fine     cache-path grouping: fine = the finer width grid with
                     groups merged over S; default = (T, S) bucket groups;
                     auto = corpus-adaptive cuts solved for this corpus
                     (data/dataset.py auto_t_cuts), groups merged over S,
                     the block-call overhead measured on the card
                     (bucket_dp_rows_per_sec overrides the frame-rows/s
                     of its cost model)
  cache=auto         device|host|auto: device keeps the prepared corpus on
                     the card and gathers batches there; auto = device when
                     the padded corpus fits cache_limit_mb (default 4096)
  mesh=0             data-parallel ranks (parallel/): 0 = every visible
                     card, N is clamped to the card count, 1 = off. With
                     device=cuda rank r takes cuda:r; with a named device
                     (cuda:0, cpu) N ranks share it (0 means 1). The ranks
                     are started here (spawn), or by a launcher such as
                     torchrun (then mesh is 0 or WORLD_SIZE). batch_size is
                     rounded up to divide by N; rank 0 prints, tests, logs
                     and saves
  compile_cache=     directory of the CUDA kernels' library
                     (utils/config.py enable_compile_cache): empty = the
                     package's _build/, off = a temporary one per process
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from clstm_tpu_torch.data.dataset import (
    T_BUCKETS, T_BUCKETS_FINE, OcrDataset, bucket_for, count_truncations,
    make_batches, pad_batch_rows, truncation_report)
from clstm_tpu_torch.data.device_cache import DeviceDataset
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import CLSTMOCR
from clstm_tpu_torch.ops.ctc import decode_frames
from clstm_tpu_torch.parallel.mesh import run_ranks
from clstm_tpu_torch.train import unpack_report
from clstm_tpu_torch.utils.config import (
    HostCopy, enable_compile_cache, getdenv, getienv, getsenv)
from clstm_tpu_torch.utils.metrics import levenshtein
from clstm_tpu_torch.utils.profiling import Throughput


def report_meter() -> Throughput:
    """The rate the train CLIs print at a report read: ``add`` the trials
    since the last read, and ``rate()`` is those trials over the time since
    it (at the first read, since the meter was made at the loop's start)."""
    meter = Throughput(window=2)
    meter.add(0)
    return meter


def evaluate(ocr: CLSTMOCR, data, codec: Codec, batch_size: int) -> float:
    """Batched test-set CER (reference test loop, clstmocrtrain.cc ≈L180).
    ``data`` is a prepared-sample list (batched on the host) or a
    DeviceDataset (batches gathered on the device)."""
    total_err = 0
    total_chars = 0
    if isinstance(data, DeviceDataset):
        batches = data.epoch(batch_size)
    else:
        batches = (pad_batch_rows(b, batch_size)
                   for b in make_batches(data, codec, batch_size))
    for batch in batches:
        host_lengths = ocr.out_lengths(
            np.asarray(batch.get("host_lengths", batch["lengths"])))
        ids, vals = ocr.predict_batch(batch["x"], batch["lengths"])
        for b, text in enumerate(batch["texts"]):
            L = host_lengths[b]
            pred = ocr.codec.decode(decode_frames(ids[b][:L], vals[b][:L]))
            total_err += levenshtein(text, pred)
            total_chars += len(text)
    return total_err / max(total_chars, 1)


def auto_steps_per_dispatch(batch_size: int, save_every: int,
                            test_every: int, has_test: bool) -> int:
    """K for steps_per_dispatch=0: at most 64, and at most the batches of
    one save or test period, so the cadences overshoot by ~one period."""
    return max(1, min(64, save_every // batch_size,
                      test_every // batch_size if has_test else 64))


def train(ocr: CLSTMOCR, codec: Codec, *, save_name: str, ntrain: int,
          batch_size: int, report_every: int = 100, save_every: int = 1000,
          test_every: int = 10000, steps_per_dispatch: int = 0,
          randseed: int = 0, log_jsonl: str = "", dcache=None,
          test_cache=None, samples=None, test_samples=None,
          display_every: int = 0) -> int:
    """The training loop of clstmocrtrain, after the corpus is loaded:
    trains ``ocr`` until ``ntrain`` trials, on the device cache ``dcache``
    (K-batch blocks, train_batch_block) or, without one, on host-built
    batches of ``samples`` (train_batch); reports, tests on ``test_cache``
    or ``test_samples`` and saves at their cadences; with ``display_every``
    > 0, rank 0 renders ``save_name``-display.png each time the trials pass
    a multiple of it, from the losses of the deferred reports and the test
    CERs (never a read of the card). Returns the trials run."""
    use_cache = dcache is not None
    has_test = bool(test_samples) or bool(test_cache)
    block_k = (steps_per_dispatch if steps_per_dispatch > 0 else
               auto_steps_per_dispatch(batch_size, save_every, test_every,
                                       has_test))
    rng = np.random.RandomState(randseed)
    jsonl = open(log_jsonl, "a") if log_jsonl else None
    trials = 0
    best_err = float("inf")
    warned_drops = False
    next_report = 0
    next_save = save_every
    next_test = test_every
    display = None
    if display_every > 0 and (ocr.mesh is None or ocr.mesh.main):
        # Imported here: it selects matplotlib's Agg back end.
        from clstm_tpu_torch.utils.display import Display
        display = Display(save_name + "-display.png")
    next_display = max(display_every, 1)
    t0 = time.time()
    meter = report_meter()
    # Deferred report: its copy to pinned memory starts when the block is
    # enqueued and is read one block later, so the card does not drain
    # while the host waits for a report.
    pending = None

    def flush_pending():
        nonlocal pending, warned_drops
        if pending is None:
            return
        copy, crossings, btexts, bhls, upto = pending
        pending = None
        rep = copy.numpy()
        meter.add(upto - meter.total)
        rate = meter.rate()
        for tr, s in crossings:
            L = int(ocr.out_lengths(int(bhls[s][0])))
            loss, ids, vals = unpack_report(rep[s], L)
            pred = codec.decode(decode_frames(ids, vals))
            print(f"{tr} {loss:.4f} ({rate:.1f} lines/s)")
            print(f"   TRU: {btexts[s][0]!r}")
            print(f"   OUT: {pred!r}", flush=True)
            if codec.dropped and not warned_drops:
                warned_drops = True
                print(f"# WARNING: {codec.dropped_report()} — these "
                      "characters cannot be learned or predicted "
                      "(deflates apparent CER)", flush=True)
            if jsonl:
                jsonl.write(json.dumps({
                    "trial": tr, "loss": loss,
                    "lines_per_sec": rate}) + "\n")
                jsonl.flush()
            if display is not None:
                display.add_loss(tr, loss)

    try:
        while trials < ntrain:
            # epochs=block_k: multi-epoch plans make every block a full k
            # batches even when a bucket group holds one batch an epoch.
            batches = (dcache.epoch_blocks(batch_size, block_k, rng=rng,
                                           epochs=block_k)
                       if use_cache
                       else make_batches(samples, codec, batch_size, rng=rng))
            for batch in batches:
                if use_cache:
                    nreal_per = batch["nreal_per"]
                    btexts, bhls = batch["texts"], batch["host_lengths"]
                    nvalid = None
                    if trials + batch["nreal"] > ntrain:
                        # ntrain budget clamp: run only enough batches of
                        # the block to reach ntrain (overshoot <= one
                        # batch, as on the one-step path).
                        nexec, acc = 0, 0
                        while acc < ntrain - trials and nexec < len(
                                nreal_per):
                            acc += nreal_per[nexec]
                            nexec += 1
                        nvalid = max(nexec, 1)
                        nreal_per = nreal_per[:nvalid]
                        btexts, bhls = btexts[:nvalid], bhls[:nvalid]
                    m = ocr.train_batch_block(batch, k_max=block_k,
                                              nvalid=nvalid)
                    report = m["report_all"]
                else:
                    m = ocr.train_batch(pad_batch_rows(batch, batch_size))
                    nreal_per = [len(batch["texts"])]
                    btexts = [batch["texts"]]
                    bhls = [np.asarray(batch["lengths"])]
                    report = m["report"][None]
                # Read the previous block's reports now that this one is
                # enqueued.
                flush_pending()
                crossings = []
                for s, n in enumerate(nreal_per):
                    trials += n
                    if trials >= next_report:
                        # max(., 1): report_every=0 means every batch.
                        while next_report <= trials:
                            next_report += max(report_every, 1)
                        crossings.append((trials, s))
                if crossings:
                    pending = (HostCopy(report), crossings, btexts, bhls,
                               trials)
                if has_test and trials >= next_test:
                    flush_pending()
                    while next_test <= trials:
                        next_test += max(test_every, 1)
                    err = evaluate(ocr, test_cache if test_cache is not None
                                   else test_samples, codec, batch_size)
                    print(f"TESTERR {trials} {err:.4f}", flush=True)
                    if jsonl:
                        jsonl.write(json.dumps({"trial": trials,
                                                "test_cer": err}) + "\n")
                        jsonl.flush()
                    if display is not None:
                        display.add_test_err(trials, err)
                    if err < best_err:
                        best_err = err
                        ocr.save(save_name + ".clstm")
                        print(f"# saved best ({err:.4f}) to "
                              f"{save_name}.clstm")
                if trials >= next_save:
                    while next_save <= trials:
                        next_save += max(save_every, 1)
                    ocr.save(save_name + "-last.clstm")
                if display is not None and trials >= next_display:
                    # Boundary-crossing gate: a block advances the trials
                    # by up to K batches, past any window of one batch.
                    while next_display <= trials:
                        next_display += max(display_every, 1)
                    display.render()
                if trials >= ntrain:
                    break
        flush_pending()
    finally:
        if jsonl:
            jsonl.close()
    ocr.save(save_name + "-last.clstm")
    if codec.dropped:
        print(f"# {codec.dropped_report()}")
    print(f"# done: {trials} trials in {time.time() - t0:.1f}s")
    return trials


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    enable_compile_cache(getsenv("compile_cache", ""))
    return run_ranks(_run, (argv,), getienv("mesh", 0),
                     getsenv("device", "cuda"))


def _run(argv, mesh=None) -> int:
    """main's work on one rank (``mesh`` None: no data parallelism)."""
    tb_mode = getsenv("t_buckets", "fine")
    save_name = getsenv("save_name", "model")
    load = getsenv("load", "")
    nhidden = getienv("nhidden", 100)
    target_height = getienv("target_height", 48)
    dewarp = getsenv("dewarp", "center")
    randseed = getienv("randseed", 0)
    batch_size = getienv("batch_size", 32)
    net_kind = getsenv("net", "bidi")
    vgsl = getsenv("vgsl", "")
    if vgsl:
        net_kind = "vgsl"
    initial = getdenv("initial", 0.0)

    train_ds = OcrDataset(argv[0], target_height=target_height, dewarp=dewarp)
    test_ds = (OcrDataset(argv[1], target_height=target_height, dewarp=dewarp)
               if len(argv) > 1 else None)
    print(f"# {len(train_ds)} training lines"
          + (f", {len(test_ds)} test lines" if test_ds else ""))

    ocr = CLSTMOCR(target_height=target_height, dewarp=dewarp,
                   device=getsenv("device", "cuda") if mesh is None
                   else mesh.device)
    if load:
        ocr.load(load)
        codec = ocr.codec
        print(f"# loaded {load}")
    else:
        codec = train_ds.build_codec()
        extra = {"initial": initial} if initial > 0 else {}
        if net_kind == "vgsl":
            extra["spec"] = vgsl
        ocr.createBidi(codec, nhidden, kind=net_kind, seed=randseed, **extra)
    ocr.setLearningRate(getdenv("lrate", 1e-4), getdenv("momentum", 0.9))
    ocr.gradient_clip = getdenv("gradient_clip", 0.0)
    ocr.augment = getdenv("augment", 0.0)
    ocr.normalization = getsenv("normalization", "none")
    print(f"# codec size {codec.size()}, net {net_kind}, nhidden {nhidden}")
    if mesh is not None:
        if batch_size % mesh.size:
            new_bs = -(-batch_size // mesh.size) * mesh.size
            print(f"# batch_size {batch_size} -> {new_bs} "
                  f"(must divide by mesh size {mesh.size})")
            batch_size = new_bs
        ocr.set_mesh(mesh)
        print(f"# data-parallel over {mesh.size} devices", flush=True)

    if tb_mode == "auto":
        # Corpus-adaptive cuts (data/dataset.py auto_t_cuts); the cost
        # model's hints mirror the loop's parameters (the automatic K is
        # at most 64).
        cache_kw = dict(t_buckets="auto", merge_sb=True,
                        auto_hints=dict(batch_size=batch_size, epochs=64,
                                        k=64))
    elif tb_mode == "fine":
        cache_kw = dict(t_buckets=T_BUCKETS_FINE, merge_sb=True)
    else:
        cache_kw = {}
    cache_kw["out_lengths"] = ocr.out_lengths
    print("# preparing lines...", flush=True)
    samples = test_samples = dcache = test_cache = None
    if getienv("device_preprocess", 0):
        # The test cache takes the default buckets, as the JAX package's.
        t_prep = time.time()
        dcache, test_cache = (DeviceDataset.from_files(
            ds.files, ds.texts(), codec, device=ocr.device, mesh=mesh,
            target_height=target_height, dewarp=dewarp, pad=ds.pad,
            **kw) if ds else None
            for ds, kw in ((train_ds, cache_kw), (test_ds, {})))
        print(f"# device-preprocessed corpus in {time.time() - t_prep:.1f}s",
              flush=True)
    else:
        samples = train_ds.load_all()
        test_samples = test_ds.load_all() if test_ds else None
        est_mb = sum(bucket_for(x.shape[0], T_BUCKETS) * x.shape[1] * 4
                     for x, _ in samples) / 1e6
        cache_mode = getsenv("cache", "auto")
        if cache_mode == "device" or (
                cache_mode == "auto"
                and est_mb <= getienv("cache_limit_mb", 4096)):
            dcache, test_cache = (
                DeviceDataset(s, codec, device=ocr.device, mesh=mesh,
                              **cache_kw)
                if s else None for s in (samples, test_samples))
    if dcache is not None:
        print(f"# device cache: {dcache.nbytes / 1e6:.0f} MB resident",
              flush=True)
        t_over, s_over = dcache.t_truncated, dcache.s_truncated
    else:
        t_over, s_over = count_truncations(samples, codec)
    if t_over or s_over:
        print(f"# WARNING: {truncation_report(t_over, s_over)}", flush=True)
    if dcache is not None and dcache.frames_short:
        print(f"# WARNING: {dcache.frames_short} line(s) with more "
              "characters than the net's output frames (CTC cannot align "
              "them)", flush=True)

    train(ocr, codec, save_name=save_name, ntrain=getienv("ntrain", 1000000),
          batch_size=batch_size, report_every=getienv("report_every", 100),
          save_every=getienv("save_every", 1000),
          test_every=getienv("test_every", 10000),
          steps_per_dispatch=getienv("steps_per_dispatch", 0),
          randseed=randseed,
          log_jsonl=getsenv("log_jsonl", "") if ocr.mesh is None
          or ocr.mesh.main else "",
          dcache=dcache, test_cache=test_cache, samples=samples,
          test_samples=test_samples,
          display_every=getienv("display_every", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
