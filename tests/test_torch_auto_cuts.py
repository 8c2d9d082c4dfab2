"""The port's corpus-adaptive T buckets (data/dataset.py auto_t_cuts) and
its dispatch measurement (data/device_cache.py
measure_dispatch_penalty_rows) against the JAX package's, on CPU.

auto_t_cuts is a pure-Python DP, so for the same arguments the two packages
must return the same tuple of ints. s_weight is passed as the JAX package's
default: the packages' own defaults are each one's accelerator's
calibration, not a shared constant.
"""

import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu.data import dataset as jds  # noqa: E402
from clstm_tpu_torch.data import dataset as tds  # noqa: E402
from clstm_tpu_torch.data import device_cache as tdc  # noqa: E402

# The JAX package's default s_weight (its TPU's calibration).
JAX_S_WEIGHT = inspect.signature(jds.auto_t_cuts).parameters[
    "s_weight"].default


def _lengths(kind: str, seed: int = 0):
    """Seeded frame lengths and their blank-interleaved target sizes: a
    bench-like corpus of 130-830 frames, or 16-4,096 frames (the whole
    T_BUCKETS range, with lines at the top bucket)."""
    rng = np.random.RandomState(seed)
    lo, hi, n = {"bench": (130, 831, 400), "wide": (16, 4097, 300)}[kind]
    lengths = rng.randint(lo, hi, size=n).tolist()
    s_lengths = [2 * max(1, v // rng.randint(8, 30)) + 1 for v in lengths]
    return lengths, s_lengths


@pytest.mark.parametrize("epochs,k,max_groups", [(64, 64, 24), (1, 1, 5)])
@pytest.mark.parametrize("penalty", [0.0, 5e3, 1e9])
@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("kind", ["bench", "wide"])
def test_torch_auto_t_cuts_match_jax(kind, lattice, penalty, epochs, k,
                                     max_groups):
    lengths, s_lengths = _lengths(kind)
    kw = dict(batch_size=32, epochs=epochs, k=k,
              dispatch_penalty_rows=penalty, max_groups=max_groups,
              s_lengths=s_lengths if lattice else None,
              s_weight=JAX_S_WEIGHT)
    got = tds.auto_t_cuts(lengths, **kw)
    want = jds.auto_t_cuts(lengths, **kw)
    assert got == want
    assert all(type(c) is int for c in got)
    assert 1 <= len(got) <= max_groups and got[-1] >= min(max(lengths),
                                                          4096)


@pytest.mark.parametrize("lengths", [[], [100000], [0, 0], [5, 100000]])
def test_torch_auto_t_cuts_degenerate_match_jax(lengths):
    """No line (-> the largest bucket alone) and lines longer than t_max
    (clamped to it), as the JAX package."""
    got = tds.auto_t_cuts(lengths, s_weight=JAX_S_WEIGHT)
    assert got == jds.auto_t_cuts(lengths, s_weight=JAX_S_WEIGHT)
    assert got[-1] == tds.T_BUCKETS[-1]


def test_torch_auto_t_cuts_default_s_weight_read_at_call(monkeypatch):
    """s_weight=None takes AUTO_S_WEIGHT as it is at the call, so setting
    it to the JAX package's value gives the JAX package's default cuts."""
    lengths, s_lengths = _lengths("wide", seed=3)
    monkeypatch.setattr(tds, "AUTO_S_WEIGHT", JAX_S_WEIGHT)
    assert tds.auto_t_cuts(lengths, s_lengths=s_lengths) == \
        jds.auto_t_cuts(lengths, s_lengths=s_lengths)
    monkeypatch.setattr(tds, "AUTO_S_WEIGHT", 1.0)
    assert tds.auto_t_cuts(lengths, s_lengths=s_lengths) == \
        jds.auto_t_cuts(lengths, s_lengths=s_lengths, s_weight=1.0)


def test_torch_measure_dispatch_penalty_rows_on_cpu(monkeypatch):
    """On the CPU the round trip is microseconds: finite and >= 0 rows;
    bucket_dp_rows_per_sec=0 gives 0, and AUTO_ROWS_PER_SEC is read at the
    call."""
    cpu = torch.device("cpu")
    v = tdc.measure_dispatch_penalty_rows(cpu)
    assert math.isfinite(v) and v >= 0.0
    monkeypatch.setattr(tdc, "AUTO_ROWS_PER_SEC", 0.0)
    assert tdc.measure_dispatch_penalty_rows(cpu, reps=3) == 0.0
    monkeypatch.setattr(tdc, "AUTO_ROWS_PER_SEC", 1e12)
    monkeypatch.setenv("bucket_dp_rows_per_sec", "0")
    assert tdc.measure_dispatch_penalty_rows(cpu) == 0.0


def test_torch_measure_dispatch_penalty_rows_needs_the_card():
    """device None is the card: without CUDA the measurement raises, where
    the JAX package would have taken 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tdc.measure_dispatch_penalty_rows()
