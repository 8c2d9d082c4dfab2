"""clstmfilter — string-transduction inference CLI (port of
clstm_tpu/cli/clstmfilter.py).

Reference: clstmfilter.cc (≈L1-100, unverified). Reads lines from stdin and
writes the transduced lines to stdout, in order. Usage:
  load=filter.clstm python -m clstm_tpu_torch.cli.clstmfilter < in.txt
Env params:
  load=filter.clstm  (required) model file
  batch_size=64      lines per batch, bucketed by input length; 1 = strict
                     line-at-a-time streaming (CLSTMText.predict)
  device=cuda        torch device; if CUDA is asked for and absent, this
                     raises rather than running on the CPU
compile_cache= directory of the CUDA kernels' library (utils/config.py
enable_compile_cache): empty = the package's _build/, off = a temporary
one per process.
"""

from __future__ import annotations

import sys

import numpy as np

from clstm_tpu_torch.data.dataset import TEXT_T_BUCKETS, bucket_for
from clstm_tpu_torch.models.hl import CLSTMText
from clstm_tpu_torch.ops.ctc import decode_frames
from clstm_tpu_torch.utils.config import (
    enable_compile_cache, getienv, getsenv)


def _predict_batched(model: CLSTMText, lines, batch_size: int) -> list:
    """Bucketed batched inference, in input order: the lines sorted by
    encoded length, ``batch_size`` a batch, each padded to its
    TEXT_T_BUCKETS bucket (longer inputs clamp at the last) and run through
    predict_batch, one forward a batch."""
    encoded = [model.encode_input(s) for s in lines]
    order = sorted(range(len(lines)), key=lambda i: encoded[i].shape[0])
    out = [""] * len(lines)
    ni = model.icodec.size()
    for lo in range(0, len(order), batch_size):
        idxs = order[lo:lo + batch_size]
        tb = bucket_for(max(encoded[i].shape[0] for i in idxs),
                        TEXT_T_BUCKETS)
        xb = np.zeros((len(idxs), tb, ni), np.float32)
        lengths = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            x = encoded[i]
            T = min(x.shape[0], tb)
            xb[r, :T] = x[:T]
            lengths[r] = T
        ids, vals = model.predict_batch(xb, lengths)
        for r, i in enumerate(idxs):
            L = lengths[r]
            out[i] = model.codec.decode(decode_frames(ids[r][:L], vals[r][:L]))
    return out


def main(argv=None) -> int:
    enable_compile_cache(getsenv("compile_cache", ""))
    load = getsenv("load", "")
    if not load:
        print(__doc__)
        return 1
    batch_size = getienv("batch_size", 64)
    model = CLSTMText(device=getsenv("device", "cuda"))
    model.load(load)
    if batch_size <= 1:
        for line in sys.stdin:
            print(model.predict(line.rstrip("\n")), flush=True)
        return 0
    lines = [ln.rstrip("\n") for ln in sys.stdin]
    for s in _predict_batched(model, lines, batch_size):
        print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
