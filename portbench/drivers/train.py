"""The training loop of clstmocrtrain on its device cache, as a driver.

The window runs what ``cli/clstmocrtrain.py::train`` runs on a device
cache: ``CLSTMOCR.train_batch_block`` over ``DeviceDataset.epoch_blocks``
(K batches a call, plans of K epochs), the deferred report copied by
``HostCopy`` and read one block later, with each crossing's report
unpacked and decoded on the host; no test, save or display.

Set-up builds the one model object from the seed (the benchmark's weights
and corpus; the net, its weights, its parameter names and the frames it
aligns over are the configuration's family's: ``run.fam``), drives it
through its first ``check_steps`` steps (the mix's number, or the
configuration's where it sets fewer) in one call of the window's own (a
block of that many batches of one epoch plan), keeping what the check
compares, warms one block of every group shape, and hands the same object
to the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import corpus, program
from portbench.reference import train as ref_train


def _cuda(run) -> bool:
    return run.device == "cuda"


def _sync(run) -> None:
    if _cuda(run):
        torch.cuda.synchronize()


def _t_buckets(name):
    from clstm_tpu_torch.data import dataset
    return {"fine": dataset.T_BUCKETS_FINE,
            "default": dataset.T_BUCKETS}[name]


def check_block(dcache, B: int, n: int, seed: int) -> dict:
    """The first block of ``n`` batches of an epoch plan drawn from the
    seed: the checked steps, every row a different line."""
    for block in dcache.epoch_blocks(B, n, rng=np.random.RandomState(
            (seed + 1) % 2 ** 32)):
        if block["k"] == n:
            return block
    raise RuntimeError(f"no group holds {n} batches of {B} lines")


def check_steps(run) -> int:
    """How many first steps the check follows: the mix's number, or fewer
    where the configuration says its reference cannot follow as many
    within the window."""
    return int(run.cfg.get("check_steps", run.mix["check_steps"]))


def setup(run) -> dict:
    from clstm_tpu_torch.data.device_cache import DeviceDataset
    cfg, mix, dev = run.cfg, run.mix, run.device
    nglyphs = cfg["noutput"] - 1
    chars = corpus.charset(nglyphs)
    parts, t = {}, time.perf_counter()
    x, widths, ids = corpus.train_lines(run.seed, mix, nglyphs, dev,
                                        height=cfg["ninput"])
    xh = x.cpu().numpy()
    del x
    texts = ["".join(chars[c - 1] for c in t) for t in ids]
    if len(set(texts)) != len(texts):
        raise RuntimeError("two corpus lines share a text")
    samples = [(xh[i, :widths[i]], texts[i]) for i in range(len(texts))]
    weights = run.fam.make_weights(cfg, corpus.generator(run.seed, 3, dev),
                                   mix["init_scale"], dev)
    ocr = program.model(cfg, run.fam, weights, dev)
    ocr.setLearningRate(mix["lrate"], mix["momentum"])
    ocr.normalization = mix["normalization"]
    dcache = DeviceDataset(samples, ocr.codec, device=dev,
                           t_buckets=_t_buckets(mix["t_buckets"]),
                           merge_sb=mix["merge_sb"])
    B, K = mix["batch_size"], mix["steps_per_dispatch"]
    _sync(run)
    parts["corpus_model_cache_s"], t = time.perf_counter() - t, \
        time.perf_counter()
    st = {"ocr": ocr, "dcache": dcache, "weights": weights, "xh": xh,
          "widths": widths, "ids": ids,
          "row_of": {t: i for i, t in enumerate(texts)}, "B": B, "K": K,
          "rng": np.random.RandomState(mix["plan_seed"])}
    # The first steps: one call of check_steps batches, as the window calls
    # a block. The first gradient comes from a one-step call on the same
    # block's first batch before it, whose update is then undone.
    names = run.fam.program_names(cfg)
    params = dict(ocr.net.named_parameters())
    p0 = {p: w.detach().clone() for p, w in params.items()}
    block = check_block(dcache, B, check_steps(run), run.seed)
    rows = [[st["row_of"][t] for t in texts] for texts in block["texts"]]
    if len({r for rs in rows for r in rs}) != sum(map(len, rows)):
        raise RuntimeError("the checked steps share a row")
    step0 = ocr.state.step
    one = {k: v for k, v in block.items() if k != "exhaust"}
    one["set_j"] = lambda j: None
    ocr.train_batch_block(one, k_max=K, nvalid=1)
    grad1 = {n: ocr.state.velocity[p].detach().clone()
             for n, p in names.items()}
    with torch.no_grad():
        for p, w in params.items():
            w.copy_(p0[p])
        for v in ocr.state.velocity.values():
            v.zero_()
    ocr.state.step = step0
    m = ocr.train_batch_block(block, k_max=K)
    losses = m["report_all"][:block["k"], 0].tolist()
    change = {n: params[p].detach() - p0[p] for n, p in names.items()}
    st["check"] = {"losses": losses, "rows": rows,
                   "grad1_norms": ref_train.norms(grad1),
                   "change_norms": ref_train.norms(change)}
    del p0, grad1, change
    parts["check_steps_s"], t = time.perf_counter() - t, time.perf_counter()
    # One block of every group shape.
    seen = set()
    for block in dcache.epoch_blocks(B, K, rng=np.random.RandomState(
            mix["plan_seed"] + 1), epochs=K):
        if block["group"]["tb"] in seen:
            continue
        seen.add(block["group"]["tb"])
        ocr.train_batch_block(block, k_max=K)
        if len(seen) == len(dcache.groups):
            break
    _sync(run)
    parts["warm_blocks_s"] = time.perf_counter() - t
    st["setup_parts"] = parts
    return st


def _blocks(st: dict):
    """The window's feed: plans of K epochs, one after another (the CLI's
    loop). Their order comes from the mix's ``plan_seed``, the same for
    every seed: a window ends inside a plan, and the blocks it leaves out
    would otherwise change the bucket mix, and the rate, from seed to
    seed."""
    while True:
        yield from st["dcache"].epoch_blocks(st["B"], st["K"], rng=st["rng"],
                                             epochs=st["K"])


def _step_records(block: dict, train: bool = True) -> list:
    g = block["group"]
    return [{"B": len(hl), "T": g["tb"], "S": g["sb"],
             "V": int(np.sum(hl)), "lines": n, "train": train}
            for hl, n in zip(block["host_lengths"], block["nreal_per"])]


class _Reports:
    """The CLI's deferred report: a block's reports are copied to pinned
    memory when it is enqueued and read one block later, each crossing of
    ``report_every`` trials unpacked and decoded on the host."""

    def __init__(self, ocr, every: int):
        from clstm_tpu_torch.utils.config import HostCopy
        self.HostCopy, self.ocr, self.every = HostCopy, ocr, every
        self.pending = None
        self.trials = 0
        self.next = 0
        self.losses = []

    def add(self, m: dict, block: dict) -> None:
        self.flush()
        crossings = []
        for s, n in enumerate(block["nreal_per"]):
            self.trials += n
            if self.trials >= self.next:
                while self.next <= self.trials:
                    self.next += max(self.every, 1)
                crossings.append(s)
        if crossings:
            self.pending = (self.HostCopy(m["report_all"]), crossings,
                            block["host_lengths"])

    def flush(self) -> None:
        from clstm_tpu_torch.ops.ctc import decode_frames
        from clstm_tpu_torch.train import unpack_report
        if self.pending is None:
            return
        copy, crossings, hls = self.pending
        self.pending = None
        rep = copy.numpy()
        for s in crossings:
            loss, ids, vals = unpack_report(rep[s], int(hls[s][0]))
            self.ocr.codec.decode(decode_frames(ids, vals))
            self.losses.append(loss)


def window(run, st: dict, seconds: float) -> dict:
    ocr, K = st["ocr"], st["K"]
    rep = _Reports(ocr, run.mix["report_every"])
    feed = _blocks(st)
    lines = frames = rows = 0
    _sync(run)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        block = next(feed)
        m = ocr.train_batch_block(block, k_max=K)
        rep.add(m, block)
        for r in _step_records(block):
            lines += r["lines"]
            frames += r["V"]
            rows += r["B"] * r["T"]
    rep.flush()
    _sync(run)
    dt = time.perf_counter() - t0
    bad = sum(not np.isfinite(v) for v in rep.losses)
    losses = [v for v in rep.losses if np.isfinite(v)]
    return {"attempted": lines, "failed": lines if bad else 0,
            "seconds": dt, "lines": lines, "valid_frames": frames,
            "frame_rows": rows,
            "end_to_end": {"train_lines_per_s": lines / dt},
            "notes": {"setup_parts": st["setup_parts"],
                      "reports": len(rep.losses), "nonfinite": bad,
                      "loss_first": losses[0] if losses else None,
                      "loss_last": losses[-1] if losses else None}}


def traced(run, st: dict) -> dict:
    """The per-layer readings: a traced stretch of the same loop
    (mix["trace_blocks"] blocks), and the host's enqueue time of a block
    on an idle card."""
    from portbench.trace import profile
    ocr, K = st["ocr"], st["K"]
    feed = _blocks(st)
    rep = _Reports(ocr, run.mix["report_every"])

    def stretch():
        steps = []
        for _ in range(run.mix["trace_blocks"]):
            block = next(feed)
            with torch.profiler.record_function("portbench.train_block"):
                m = ocr.train_batch_block(block, k_max=K)
            with torch.profiler.record_function("portbench.report"):
                rep.add(m, block)
            steps += _step_records(block)
        with torch.profiler.record_function("portbench.report"):
            rep.flush()
        return steps

    before = program.launch_counts()
    steps, tr = profile(stretch)
    launches = {k: v - before[k] for k, v in program.launch_counts().items()}
    enq = []
    for _ in range(run.mix["enqueue_blocks"]):
        block = next(feed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ocr.train_batch_block(block, k_max=K)
        enq.append((time.perf_counter() - t0) * 1e3 / block["k"])
    torch.cuda.synchronize()
    return {"trace": tr, "steps": steps, "launches": launches,
            "enqueue_ms": float(np.mean(enq))}


def check_batches(run, st: dict) -> list:
    """The first steps' batches as the reference takes them: the same rows
    of the benchmark's corpus, found by their texts, with the frames the
    family aligns over. Frees the program's state."""
    widths, xh = st["widths"], st["xh"]
    for k in ("ocr", "dcache"):
        st.pop(k, None)
    if _cuda(run):
        torch.cuda.empty_cache()
    batches = []
    for rows in st["check"]["rows"]:
        T = int(max(widths[r] for r in rows))
        x = np.zeros((len(rows), T, xh.shape[2]), np.float32)
        for i, r in enumerate(rows):
            x[i, :widths[r]] = xh[r, :widths[r]]
        L = torch.as_tensor([int(widths[r]) for r in rows],
                            device=run.device)
        batches.append({
            "x": torch.as_tensor(x, device=run.device), "lengths": L,
            "olengths": run.fam.out_lengths(run.cfg, L),
            "texts": [st["ids"][r] for r in rows], "rows": st["B"]})
    return batches


def judge(run, st: dict) -> dict:
    """The program's first steps against the reference's, on the same
    rows, from the same weights; the program's state is freed first."""
    batches = check_batches(run, st)
    ref = ref_train.steps(run.fam, st["weights"], batches, run.mix["lrate"],
                          run.mix["momentum"])
    return ref_train.numbers(st["check"], ref)
