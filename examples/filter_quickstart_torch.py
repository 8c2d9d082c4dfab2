"""String-transduction quickstart on the PyTorch port (clstm_tpu_torch):
train a CLSTMText filter (the clstmfiltertrain/clstmfilter model) on a toy
spelling-normalization task, batched, then run it like a unix filter and
round-trip the .clstm file. The same flow as examples/filter_quickstart.py.

Run:  python examples/filter_quickstart_torch.py [--device cuda]
                                                 [--pairs 600] [--epochs 60]
(on the card by default; --device cpu runs it on the CPU, slower)
"""

import argparse
import os
import sys
import tempfile

import numpy as np

# Runnable without installing: `python examples/filter_quickstart_torch.py`
# puts examples/ on sys.path, not the repo root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from clstm_tpu_torch import CLSTMText  # noqa: E402
from clstm_tpu_torch.cli.clstmfiltertrain import evaluate  # noqa: E402
from clstm_tpu_torch.data.dataset import (  # noqa: E402
    make_text_batches, pad_batch_rows)
from clstm_tpu_torch.models.codec import Codec  # noqa: E402


def main(device: str = "cuda", pairs: int = 600, epochs: int = 60,
         nhidden: int = 64) -> float:
    """Returns the held-out CER at the end."""
    # 1. A toy transduction: strip vowel doubling ("aa" -> "a") — the same
    #    shape of task as the reference's run-cmu grapheme->phoneme recipe
    #    (input/output codecs differ; output is shorter than input).
    rng = np.random.RandomState(0)
    letters = list("abcdefgh")

    def sample():
        out = "".join(rng.choice(letters) for _ in range(rng.randint(3, 9)))
        inp = "".join(c * 2 if c in "aeiou" else c for c in out)
        return inp, out

    all_pairs = sorted({sample() for _ in range(pairs)})
    n_test = max(1, len(all_pairs) // 6)
    train_pairs, test_pairs = all_pairs[:-n_test], all_pairs[-n_test:]

    # 2. Model: same bidi LSTM machinery as OCR; the input is one-hot
    #    characters instead of image columns. input_repeat gives the CTC
    #    alignment slack when outputs are nearly as long as inputs.
    model = CLSTMText(input_repeat=2, device=device)
    model.createBidi(Codec.build(a for a, _ in train_pairs),
                     Codec.build(b for _, b in train_pairs),
                     nhidden=nhidden)
    model.setLearningRate(3e-4, 0.9)

    # 3. Batched training (bucketed padded batches, one step a batch).
    err = evaluate(model, test_pairs, batch_size=16)
    for epoch in range(epochs):
        for batch in make_text_batches(train_pairs, model.icodec, model.codec,
                                       16, rng=rng,
                                       input_repeat=model.input_repeat):
            model.train_batch(pad_batch_rows(batch, 16))
        if epoch % 20 == 19 or epoch == epochs - 1:
            err = evaluate(model, test_pairs, batch_size=16)
            print(f"epoch {epoch + 1}: test CER {err:.4f}")

    # 4. Use it like the clstmfilter CLI: string in, string out.
    for inp, truth in test_pairs[:5]:
        print(f"{inp!r} -> {model.predict(inp)!r}   (truth {truth!r})")

    # 5. Save/load the .clstm (reference format; includes both codecs).
    path = os.path.join(tempfile.mkdtemp(), "filter.clstm")
    model.save(path)
    clone = CLSTMText(device=device)
    clone.load(path)
    assert clone.predict(test_pairs[0][0]) == model.predict(test_pairs[0][0])
    print("saved + reloaded:", path)
    return err


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pairs", type=int, default=600)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--nhidden", type=int, default=64)
    main(**vars(ap.parse_args()))
