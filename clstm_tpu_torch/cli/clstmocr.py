"""clstmocr — OCR inference CLI (port of clstm_tpu/cli/clstmocr.py).

Reference: clstmocr.cc (≈L1-150, unverified). Usage:
  load=model.clstm python -m clstm_tpu_torch.cli.clstmocr IMG.png [IMG2.png ...]
Env params:
  load=model.clstm  (required) model file
  output=text       "text" prints to stdout; "sidecar" writes IMG.txt files
  charseg=0         also print per-character x positions (CharPrediction,
                    in ORIGINAL image columns)
  dewarp=center     normalizer kind; target_height is the model's input size
  device=cuda       torch device; if CUDA is asked for and absent, this
                    raises rather than running on the CPU
  device_preprocess=1  run the normalization/transposition on the device
                    (ops/preprocess.py); 0 = host scipy path
  compile_cache=    directory of the CUDA kernels' library (utils/config.py
                    enable_compile_cache): empty = the package's _build/,
                    off = a temporary one per process
All given images are bucketed by width and run as batches, not one by one.
"""

from __future__ import annotations

import sys

import numpy as np

from clstm_tpu_torch.data.dataset import T_BUCKETS, bucket_for
from clstm_tpu_torch.io.png import read_png
from clstm_tpu_torch.models.hl import CLSTMOCR
from clstm_tpu_torch.ops.ctc import decode_frames
from clstm_tpu_torch.ops.preprocess import estimate_out_T
from clstm_tpu_torch.utils.config import (
    HostCopy, enable_compile_cache, getienv, getsenv)


def predict_pages(ocr: CLSTMOCR, images, device_preprocess: int = 1) -> dict:
    """The CLI's bucketed batched page-inference core: -> {image index:
    (frame classes, peak positions, frame vals, width scale)}."""
    if device_preprocess:
        return _predict_pages_device(ocr, images)
    results: dict = {}
    prepared = []
    scales = []
    for img in images:
        prepared.append(ocr.prepare(img))
        scales.append(ocr._scale)
    by_bucket: dict = {}
    for i, x in enumerate(prepared):
        tb = bucket_for(x.shape[0], T_BUCKETS)
        by_bucket.setdefault(tb, []).append(i)
    for tb, idxs in by_bucket.items():
        H = prepared[idxs[0]].shape[1]
        xb = np.zeros((len(idxs), tb, H), np.float32)
        lengths = np.zeros(len(idxs), np.int32)
        for r, i in enumerate(idxs):
            x = prepared[i]
            T = min(x.shape[0], tb)
            xb[r, :T] = x[:T]
            lengths[r] = T
        ids, vals = ocr.predict_batch(xb, lengths)
        for r, i in enumerate(idxs):
            L = lengths[r]
            cls, pos = decode_frames(ids[r][:L], vals[r][:L],
                                     return_positions=True)
            results[i] = (cls, pos, vals[r], scales[i])
    return results


def _predict_pages_device(ocr: CLSTMOCR, images) -> dict:
    """predict_pages with the normalization on the device: raw lines are
    bucketed by their ESTIMATED normalized width, one upload, prepare and
    predict per bucket. Two phases: every bucket is enqueued, its results
    copied back into pinned buffers without waiting, before any is read, so
    the buckets' uploads, compute and copies overlap; then each bucket is
    waited for once and decoded."""
    by_bucket: dict = {}
    for i, img in enumerate(images):
        tb = bucket_for(estimate_out_T([img], ocr.target_height, ocr.pad),
                        T_BUCKETS)
        by_bucket.setdefault(tb, []).append(i)
    pending = []
    for idxs in by_bucket.values():
        out = ocr.predict_batch_images([images[i] for i in idxs], sync=False)
        pending.append((idxs, [HostCopy(t) for t in out]))
    results: dict = {}
    for idxs, copies in pending:
        ids, vals, lengths = (c.numpy() for c in copies)
        for r, i in enumerate(idxs):
            L = int(lengths[r])
            cls, pos = decode_frames(ids[r][:L], vals[r][:L],
                                     return_positions=True)
            # width scale: normalized cols per source col
            scale = max(L - 2 * ocr.pad, 1) / max(images[i].shape[1], 1)
            results[i] = (cls, pos, vals[r], scale)
    return results


def write_outputs(ocr: CLSTMOCR, argv, images, results: dict,
                  output: str = "text", charseg: int = 0) -> None:
    """Decode + emit results (stdout or .txt sidecars; reference output
    stage of clstmocr.cc)."""
    for i, f in enumerate(argv):
        cls, pos, vals, scale = results[i]
        text = ocr.codec.decode(cls)
        if output == "sidecar":
            out = f
            for ext in (".png", ".jpg", ".jpeg"):
                if out.endswith(ext):
                    out = out[: -len(ext)]
                    break
            with open(out + ".txt", "w", encoding="utf-8") as fh:
                fh.write(text + "\n")
        else:
            print(f"{f}\t{text}")
        if charseg:
            w = images[i].shape[1]
            for j, (c, t) in enumerate(zip(cls, pos)):
                ch = chr(ocr.codec.codec[c])
                col = int(np.clip(round((t - ocr.pad) / scale), 0, w - 1))
                print(f"# {j} {col} {ch!r} {vals[t]:.3f}")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    enable_compile_cache(getsenv("compile_cache", ""))
    load = getsenv("load", "")
    if not load or not argv:
        print(__doc__)
        return 1
    output = getsenv("output", "text")
    charseg = getienv("charseg", 0)
    dewarp = getsenv("dewarp", "center")
    device_preprocess = getienv("device_preprocess", 1)

    ocr = CLSTMOCR(dewarp=dewarp, device=getsenv("device", "cuda"))
    ocr.load(load)
    # target_height is the net's input dim (persisted in proto attrs).
    ocr.target_height = ocr.spec.iget("ninput", ocr.target_height)

    images = [read_png(f) for f in argv]
    results = predict_pages(ocr, images, device_preprocess)
    write_outputs(ocr, argv, images, results, output, charseg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
