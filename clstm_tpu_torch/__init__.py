"""clstm_tpu_torch — the PyTorch/CUDA port of clstm_tpu for NVIDIA Hopper.

The JAX package ``clstm_tpu`` stays the reference; this package mirrors its
module paths and function names so each counterpart is found at once, and
never imports JAX or ``clstm_tpu`` (only the tests import both).

What is ported so far is the serving path that ``clstmocr`` runs:

  - io/         the .clstm model format (written by hand, no protobuf
                package), line normalisers, PNG I/O
  - models/     codec, layer tree (NetSpec + nn.Module per layer kind),
                prefabs, the high-level CLSTMOCR prediction API
  - ops/        sequence helpers, nonlinearities, the plain LSTM loops, the
                greedy CTC decode, and the bidirectional LSTM inference
                kernel (csrc/bidi_lstm_fwd.cu, CUDA C++ for sm_90a)
  - data/       line preparation and width buckets
  - cli/        clstmocr
  - convert.py  JAX params pytree (as numpy) <-> the port's modules

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
