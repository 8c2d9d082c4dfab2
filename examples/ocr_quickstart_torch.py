"""End-to-end OCR quickstart on the PyTorch port (clstm_tpu_torch): render
a synthetic dataset, train a bidi LSTM with CTC alignment, recognize,
save/load the .clstm model. The same flow as examples/ocr_quickstart.py.

Run:  python examples/ocr_quickstart_torch.py [--device cuda] [--lines 64]
                                              [--epochs 1200] [--nhidden 100]
(on the card by default; --device cpu runs it on the CPU, slower)
"""

import argparse
import os
import sys
import tempfile

import numpy as np

# Runnable without installing: `python examples/ocr_quickstart_torch.py`
# puts examples/ on sys.path, not the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clstm_tpu_torch import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.cli.clstmocrtrain import evaluate  # noqa: E402
from clstm_tpu_torch.data.dataset import OcrDataset, make_batches  # noqa: E402
from clstm_tpu_torch.data.lines import LineGenerator, make_dataset_dir  # noqa: E402
from clstm_tpu_torch.io.png import read_png  # noqa: E402


def main(device: str = "cuda", lines: int = 64, epochs: int = 1200,
         nhidden: int = 100) -> float:
    """Returns the training set's CER at the end."""
    # 1. A synthetic dataset: PNG line images + .gt.txt transcripts + manifest
    #    (swap in your own manifest of real line images here).
    work = tempfile.mkdtemp()
    gen = LineGenerator(seed=0)
    texts = [gen.random_sentence() for _ in range(lines)]
    manifest = make_dataset_dir(work, len(texts), gen=gen, texts=texts)
    ds = OcrDataset(manifest, target_height=48, dewarp="center")

    # 2. Model: the reference's standard bidirectional LSTM recognizer.
    codec = ds.build_codec()
    ocr = CLSTMOCR(target_height=48, dewarp="center", device=device)
    ocr.createBidi(codec, nhidden=nhidden)
    ocr.setLearningRate(6e-4, 0.9)
    ocr.gradient_clip = 10.0

    # 3. Batched CTC-alignment training (width-bucketed padded batches).
    samples = ds.load_all()
    rng = np.random.RandomState(0)
    err = evaluate(ocr, samples, codec, 16)
    for epoch in range(epochs):
        for batch in make_batches(samples, codec, batch_size=16, rng=rng):
            metrics = ocr.train_batch(batch)
        if epoch % 300 == 299 or epoch == epochs - 1:
            err = evaluate(ocr, samples, codec, 16)
            print(f"epoch {epoch + 1}: loss {float(metrics['loss']):.1f} "
                  f"train CER {err:.4f}")

    # 4. Recognize a line (reference single-line API).
    img = read_png(ds.files[0])
    print("truth:", ds.text(0))
    print("pred: ", ocr.predict_utf8(img))
    for cp in ocr.predict(img)[:5]:
        print(f"  char {cp.c!r} at x={cp.x} p={cp.p:.2f}")

    # 5. Save / reload the .clstm model (reference proto format).
    ocr.save(f"{work}/model.clstm")
    ocr2 = CLSTMOCR(target_height=48, dewarp="center", device=device)
    ocr2.load(f"{work}/model.clstm")
    assert ocr2.predict_utf8(img) == ocr.predict_utf8(img)
    print(f"model round-tripped through {work}/model.clstm")
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lines", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=1200)
    ap.add_argument("--nhidden", type=int, default=100)
    main(**vars(ap.parse_args()))
