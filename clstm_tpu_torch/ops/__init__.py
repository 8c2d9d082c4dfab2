"""Compute: plain PyTorch ops and the wrappers of the hand-written CUDA
kernels (port of clstm_tpu/ops).

The plain versions (ops/lstm.py, ops/ctc.py) run on any device; on a CUDA
tensor the wrappers in ops/bidi_lstm_kernel.py and ops/ctc_kernel.py launch
the kernels of csrc/ instead. Exports the JAX package's names.
"""

from clstm_tpu_torch.ops.nonlin import NONLIN, nonlin_apply
from clstm_tpu_torch.ops.lstm import lstm_init, lstm_apply
from clstm_tpu_torch.ops.ctc import (
    forward_algorithm,
    ctc_align_targets,
    ctc_align_targets_batched,
    mktargets,
    trivial_decode,
)

__all__ = [
    "NONLIN",
    "nonlin_apply",
    "lstm_init",
    "lstm_apply",
    "forward_algorithm",
    "ctc_align_targets",
    "ctc_align_targets_batched",
    "mktargets",
    "trivial_decode",
]
