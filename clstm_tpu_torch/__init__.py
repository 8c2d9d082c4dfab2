"""clstm_tpu_torch — the PyTorch/CUDA port of clstm_tpu for NVIDIA Hopper.

The JAX package ``clstm_tpu`` stays the reference; this package mirrors its
module paths and function names so each counterpart is found at once, and
never imports JAX or ``clstm_tpu`` (only the tests import both).

What is ported so far is the serving path that ``clstmocr`` runs and one
CTC training step of the OCR net (CLSTMOCR.train_batch / train_utf8):

  - io/         the .clstm model format (written by hand, no protobuf
                package), the .state.npz TrainState sidecar, line
                normalisers, PNG I/O
  - models/     codec, layer tree (NetSpec + nn.Module per layer kind),
                prefabs, the high-level CLSTMOCR API (train and predict)
  - ops/        sequence helpers, nonlinearities, the plain LSTM loops, CTC
                alignment and greedy decode, and the CUDA C++ kernels for
                sm_90a (csrc/): the bidirectional LSTM forward for serving
                (K3) and training (K1), its backward (K2), and the CTC
                alignment DP (K5, K6)
  - train.py    TrainState, the CTC and frame losses, heavy-ball SGD, the
                train, predict and forward steps
  - data/       line preparation, width and target-length buckets
  - cli/        clstmocr
  - convert.py  JAX params pytree and TrainState (as numpy) <-> the port

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"
