"""clstmfiltertrain — string-transduction training CLI (port of
clstm_tpu/cli/clstmfiltertrain.py).

Reference: clstmfiltertrain.cc (≈L1-200, unverified). Usage:
  python -m clstm_tpu_torch.cli.clstmfiltertrain TRAIN.tsv [TEST.tsv]
where each line is ``input<TAB>output`` (a line without a tab maps to
itself). Env params, with the JAX package's names and defaults:
  save_name=filter   checkpoint basename (.clstm appended)
  load=              resume from a .clstm checkpoint (and its .state.npz)
  ntrain=1000000     number of training pairs (trials)
  lrate=1e-4         learning rate
  momentum=0.9
  nhidden=100        hidden units per direction
  report_every=100   print truth/pred lines
  save_every=1000    periodic checkpoint (save_name-last.clstm)
  test_every=10000   evaluate the test set's CER, keep the best model
  randseed=0         weight init and epoch shuffles
  net=bidi           prefab kind
  batch_size=1       1: the reference's pair-at-a-time loop
                     (CLSTMText.train); >1 bucketed batches
  input_repeat=1     repeat each input frame k times (CTC alignment slack)
  log_jsonl=         path for structured JSONL metrics
  cache=auto         device|host|auto: host streams host-built one-hot
                     batches (train_batched); device and auto keep the
                     corpus on the card as int ids (TextDeviceDataset,
                     4 bytes a frame) and expand them to one-hot in the
                     step (train_blocks)
  steps_per_dispatch=0  K batches per call over the device plan; 0 = auto
                     (K <= 64, clamped to the save and test cadences)
  device=cuda        torch device; if CUDA is asked for and absent, this
                     raises rather than running on the CPU
  mesh=0             data-parallel ranks on the batched path (batch_size >
                     1), as clstmocrtrain's mesh: 0 = every visible card,
                     N clamped to the card count, 1 = off, N ranks sharing
                     a named device (cuda:0, cpu); batch_size is rounded up
                     to divide by N; rank 0 prints, tests, logs and saves
compile_cache= directory of the CUDA kernels' library (utils/config.py
enable_compile_cache): empty = the package's _build/, off = a temporary
one per process.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from clstm_tpu_torch.cli.clstmfilter import _predict_batched
from clstm_tpu_torch.cli.clstmocrtrain import (
    auto_steps_per_dispatch, report_meter)
from clstm_tpu_torch.data.dataset import (
    S_BUCKETS, TEXT_T_BUCKETS, make_text_batches, pad_batch_rows,
    truncation_report)
from clstm_tpu_torch.data.device_cache import TextDeviceDataset
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import TEXT_ONE_BUCKETS, CLSTMText
from clstm_tpu_torch.ops.ctc import decode_frames
from clstm_tpu_torch.parallel.mesh import run_ranks
from clstm_tpu_torch.train import unpack_report
from clstm_tpu_torch.utils.config import (
    HostCopy, enable_compile_cache, getdenv, getienv, getsenv)
from clstm_tpu_torch.utils.metrics import levenshtein


def read_tsv(fname: str):
    pairs = []
    with open(fname, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if "\t" in line:
                a, b = line.split("\t", 1)
            else:
                a, b = line, line
            pairs.append((a, b))
    return pairs


def evaluate(model: CLSTMText, pairs, batch_size: int = 1) -> float:
    """Test-set CER: batched (clstmfilter's _predict_batched) for
    batch_size > 1, else one pair at a time."""
    if batch_size > 1:
        preds = _predict_batched(model, [a for a, _ in pairs], batch_size)
    else:
        preds = (model.predict(a) for a, _ in pairs)
    err = chars = 0
    for (_, b), pred in zip(pairs, preds):
        err += levenshtein(b, pred)
        chars += len(b)
    return err / max(chars, 1)


class _Log:
    """The JSONL metrics file (log_jsonl=), or nothing."""

    def __init__(self, path: str):
        self.f = open(path, "a") if path else None

    def write(self, **rec) -> None:
        if self.f:
            self.f.write(json.dumps(rec) + "\n")
            self.f.flush()

    def close(self) -> None:
        if self.f:
            self.f.close()


def _test(model, test_pairs, trials, batch_size, best_err, save_name, log):
    """Evaluate, print TESTERR, keep the best model. -> the best CER."""
    err = evaluate(model, test_pairs, batch_size)
    print(f"TESTERR {trials} {err:.4f}", flush=True)
    log.write(trial=trials, test_cer=err)
    if err < best_err:
        best_err = err
        model.save(save_name + ".clstm")
        print(f"# saved best ({err:.4f}) to {save_name}.clstm")
    return best_err


def _report(model, trials, loss, ids, vals, text, meter, log) -> None:
    pred = model.codec.decode(decode_frames(ids, vals))
    rate = meter.rate()
    print(f"{trials} {loss:.4f} ({rate:.1f} pairs/s)")
    print(f"   TRU: {text!r}")
    print(f"   OUT: {pred!r}", flush=True)
    log.write(trial=trials, loss=loss, pairs_per_sec=rate)


def train_batched(model: CLSTMText, train_pairs, test_pairs, *, ntrain,
                  batch_size, report_every, save_every, test_every,
                  save_name, rng, log) -> int:
    """Bucketed batched training on host-built one-hot batches (cache=host):
    one train_batch a batch. -> the trials run."""
    trials = 0
    best_err = float("inf")
    next_report, next_save, next_test = report_every, save_every, test_every
    meter = report_meter()
    while trials < ntrain:
        for batch in make_text_batches(train_pairs, model.icodec, model.codec,
                                       batch_size, rng=rng,
                                       input_repeat=model.input_repeat):
            m = model.train_batch(pad_batch_rows(batch, batch_size))
            trials += len(batch["texts"])
            if trials >= next_report:
                next_report += report_every
                loss, ids, vals = unpack_report(m["report"],
                                                batch["lengths"][0])
                meter.add(trials - meter.total)
                _report(model, trials, loss, ids, vals, batch["texts"][0],
                        meter, log)
            if test_pairs and trials >= next_test:
                next_test += test_every
                best_err = _test(model, test_pairs, trials, batch_size,
                                 best_err, save_name, log)
            if trials >= next_save:
                next_save += save_every
                model.save(save_name + "-last.clstm")
            if trials >= ntrain:
                break
    model.save(save_name + "-last.clstm")
    return trials


def train_blocks(model: CLSTMText, dcache: TextDeviceDataset, test_pairs, *,
                 ntrain, batch_size, block_k, report_every, save_every,
                 test_every, save_name, rng, log) -> int:
    """K-batch blocks over the device-resident text corpus
    (train_batch_block), the reports of a block copied back without waiting
    (HostCopy) and read one block later, trial-based cadences, the ntrain
    clamp. -> the trials run."""
    trials = 0
    best_err = float("inf")
    next_report = 0
    next_save, next_test = save_every, test_every
    meter = report_meter()
    # Deferred report: (copy of report_all, crossings, texts, lengths, the
    # trials through the block), read after the next block is enqueued so
    # the card does not drain while the host waits for it.
    pending = None

    def flush_pending():
        nonlocal pending
        if pending is None:
            return
        copy, crossings, btexts, bhls, upto = pending
        pending = None
        rep = copy.numpy()
        meter.add(upto - meter.total)
        for tr, s in crossings:
            loss, ids, vals = unpack_report(rep[s], int(bhls[s][0]))
            _report(model, tr, loss, ids, vals, btexts[s][0], meter, log)

    while trials < ntrain:
        # epochs=block_k: multi-epoch plans keep every block at a full k
        # batches even when a bucket group holds one batch an epoch.
        for block in dcache.epoch_blocks(batch_size, block_k, rng=rng,
                                         epochs=block_k):
            nreal_per = block["nreal_per"]
            btexts, bhls = block["texts"], block["host_lengths"]
            nvalid = None
            if trials + block["nreal"] > ntrain:
                # ntrain budget clamp: run only enough batches of the block
                # to reach ntrain (overshoot <= one batch).
                nexec, acc = 0, 0
                while acc < ntrain - trials and nexec < len(nreal_per):
                    acc += nreal_per[nexec]
                    nexec += 1
                nvalid = max(nexec, 1)
                nreal_per = nreal_per[:nvalid]
                btexts, bhls = btexts[:nvalid], bhls[:nvalid]
            m = model.train_batch_block(block, k_max=block_k, nvalid=nvalid)
            flush_pending()
            crossings = []
            for s, n in enumerate(nreal_per):
                trials += n
                if trials >= next_report:
                    while next_report <= trials:
                        next_report += max(report_every, 1)
                    crossings.append((trials, s))
            if crossings:
                pending = (HostCopy(m["report_all"]), crossings, btexts, bhls,
                           trials)
            if test_pairs and trials >= next_test:
                flush_pending()
                while next_test <= trials:
                    next_test += max(test_every, 1)
                best_err = _test(model, test_pairs, trials, batch_size,
                                 best_err, save_name, log)
            if trials >= next_save:
                while next_save <= trials:
                    next_save += max(save_every, 1)
                model.save(save_name + "-last.clstm")
            if trials >= ntrain:
                break
    flush_pending()
    model.save(save_name + "-last.clstm")
    return trials


def train_pairs_one(model: CLSTMText, train_pairs, test_pairs, *, ntrain,
                    report_every, save_every, test_every, save_name, rng,
                    log) -> int:
    """The reference's loop (batch_size=1): one random pair a step through
    CLSTMText.train. -> the trials run."""
    trials = 0
    best_err = float("inf")
    meter = report_meter()
    while trials < ntrain:
        a, b = train_pairs[rng.randint(len(train_pairs))]
        pred = model.train(a, b)
        trials += 1
        if trials % report_every == 0:
            meter.add(trials - meter.total)
            print(f"{trials} ({meter.rate():.1f} pairs/s)")
            print(f"   INP: {a!r}")
            print(f"   TRU: {b!r}")
            print(f"   OUT: {pred!r}", flush=True)
        if test_pairs and trials % test_every == 0:
            best_err = _test(model, test_pairs, trials, 1, best_err,
                             save_name, log)
        if trials % save_every == 0:
            model.save(save_name + "-last.clstm")
    model.save(save_name + "-last.clstm")
    return trials


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    enable_compile_cache(getsenv("compile_cache", ""))
    # The mesh applies only on the batched path, where rows can be split.
    mesh_n = getienv("mesh", 0) if getienv("batch_size", 1) > 1 else 1
    return run_ranks(_run, (argv,), mesh_n, getsenv("device", "cuda"))


def _run(argv, mesh=None) -> int:
    """main's work on one rank (``mesh`` None: no data parallelism)."""
    save_name = getsenv("save_name", "filter")
    load = getsenv("load", "")
    ntrain = getienv("ntrain", 1000000)
    report_every = getienv("report_every", 100)
    save_every = getienv("save_every", 1000)
    test_every = getienv("test_every", 10000)
    randseed = getienv("randseed", 0)
    batch_size = getienv("batch_size", 1)

    train_pairs = read_tsv(argv[0])
    test_pairs = read_tsv(argv[1]) if len(argv) > 1 else None
    print(f"# {len(train_pairs)} training pairs"
          + (f", {len(test_pairs)} test pairs" if test_pairs else ""))

    model = CLSTMText(input_repeat=getienv("input_repeat", 1),
                      device=getsenv("device", "cuda") if mesh is None
                      else mesh.device)
    if load:
        model.load(load)
        print(f"# loaded {load}")
    else:
        icodec = Codec.build(a for a, _ in train_pairs)
        codec = Codec.build(b for _, b in train_pairs)
        model.createBidi(icodec, codec, getienv("nhidden", 100),
                         kind=getsenv("net", "bidi"), seed=randseed)
    model.setLearningRate(getdenv("lrate", 1e-4), getdenv("momentum", 0.9))

    # Over-bucket truncation: inputs longer than the path's last T bucket
    # lose frames; outputs whose blank-interleaved targets overflow
    # S_BUCKETS train toward a truncated string.
    k = model.input_repeat
    tb = TEXT_T_BUCKETS if batch_size > 1 else TEXT_ONE_BUCKETS
    t_over = sum(len(model.icodec.encode(a)) * k > tb[-1]
                 for a, _ in train_pairs)
    s_over = sum(2 * len(model.codec.encode(b)) + 1 > S_BUCKETS[-1]
                 for _, b in train_pairs)
    if t_over or s_over:
        print("# WARNING: "
              + truncation_report(t_over, s_over, tb, S_BUCKETS), flush=True)

    if mesh is not None:
        if batch_size % mesh.size:
            batch_size = -(-batch_size // mesh.size) * mesh.size
            print(f"# batch_size -> {batch_size} (mesh {mesh.size})")
        model.set_mesh(mesh)
        print(f"# data-parallel over {mesh.size} devices", flush=True)

    rng = np.random.RandomState(randseed)
    log = _Log(getsenv("log_jsonl", "") if mesh is None or mesh.main
               else "")
    cadence = dict(ntrain=ntrain, report_every=report_every,
                   save_every=save_every, test_every=test_every,
                   save_name=save_name, rng=rng, log=log)
    try:
        if batch_size <= 1:
            train_pairs_one(model, train_pairs, test_pairs, **cadence)
        elif getsenv("cache", "auto") == "host":
            train_batched(model, train_pairs, test_pairs,
                          batch_size=batch_size, **cadence)
        else:
            # A text corpus is small on the card (4 bytes a frame), so
            # "auto" always caches.
            dcache = TextDeviceDataset(train_pairs, model.icodec,
                                       model.codec, input_repeat=k,
                                       device=model.device, mesh=mesh)
            print(f"# device cache: {dcache.nbytes / 1e6:.1f} MB resident",
                  flush=True)
            steps = getienv("steps_per_dispatch", 0)
            block_k = steps if steps > 0 else auto_steps_per_dispatch(
                batch_size, save_every, test_every, bool(test_pairs))
            train_blocks(model, dcache, test_pairs, batch_size=batch_size,
                         block_k=block_k, **cadence)
    finally:
        log.close()
    for name, c in (("codec", model.codec), ("icodec", model.icodec)):
        if c is not None and c.dropped:
            print(f"# WARNING [{name}]: {c.dropped_report()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
