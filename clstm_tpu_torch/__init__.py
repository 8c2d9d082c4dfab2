"""clstm_tpu_torch — the PyTorch/CUDA port of clstm_tpu for NVIDIA Hopper.

The JAX package ``clstm_tpu`` stays the reference; this package mirrors its
module paths and function names so each counterpart is found at once, and
never imports JAX or ``clstm_tpu`` (only the tests import both).

What is ported so far is OCR serving (``clstmocr``, with the line
normalization on the host or on the device), OCR training
(``clstmocrtrain``, on a corpus held on the device), string transduction
(``clstmfiltertrain``, ``clstmfilter``) and data-parallel training over
torch.distributed (the trainers' ``mesh=N``):

  - io/         the .clstm model format (written by hand, no protobuf
                package), the .state.npz TrainState sidecar, line
                normalisers, PNG I/O, and the ctypes binding of the native
                host I/O runtime (native/clstm_io.cc, built with g++ at
                first use)
  - models/     codec, layer tree (NetSpec + nn.Module per layer kind),
                prefabs, the high-level CLSTMOCR and CLSTMText APIs (train
                and predict, from prepared batches, raw line images, text
                or the device cache)
  - ops/        sequence helpers, nonlinearities, the plain LSTM loops, CTC
                alignment and greedy decode, on-device line preprocessing
                and augmentation (preprocess.py), and the CUDA C++ kernels
                for sm_90a (csrc/): the bidirectional LSTM forward for
                serving (K3, K4) and training (K1, K4), its backward (K2),
                and the CTC alignment DP (K5, K6, K6b)
  - train.py    TrainState, the CTC and frame losses, heavy-ball SGD, the
                train, cached, K-step, predict and forward steps
  - data/       line preparation, width and target-length buckets,
                manifests and batches, text batches, the synthetic line
                renderer, the device-resident corpus caches (line frames,
                or text as int ids expanded to one-hot in the step), the
                delayed-sequence task (synth.py)
  - parallel/   data parallelism: the rank's group, device and backend,
                the spawn launch, replication, and the training steps
                that sum the loss and gradients over the ranks
  - utils/      env config and the device, host/device copies, CER, text,
                the torch.profiler trace and throughput meters
                (profiling.py), the training dashboard (display.py)
  - cli/        clstmocr, clstmocrtrain, clstmfilter, clstmfiltertrain
  - convert.py  JAX params pytree and TrainState (as numpy) <-> the port

On CPU tensors every kernel wrapper runs its plain PyTorch version; on CUDA
tensors it launches the kernel or raises.
"""

__version__ = "0.1.0"

from clstm_tpu_torch.models.spec import (  # noqa: E402
    NetSpec, apply_net, init_net, network_info)
from clstm_tpu_torch.models.prefab import make_net, make_net_init  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import (  # noqa: E402
    CLSTMOCR, CLSTMText, CharPrediction)
from clstm_tpu_torch.ops.ctc import (  # noqa: E402
    ctc_align_targets, mktargets, trivial_decode)
from clstm_tpu_torch.io.proto import load_net, save_net  # noqa: E402
from clstm_tpu_torch.train import (  # noqa: E402
    TrainState, make_train_step, sgd_update)

# The JAX package's __all__, name for name.
__all__ = [
    "NetSpec",
    "init_net",
    "apply_net",
    "network_info",
    "make_net",
    "make_net_init",
    "Codec",
    "CLSTMOCR",
    "CLSTMText",
    "CharPrediction",
    "ctc_align_targets",
    "mktargets",
    "trivial_decode",
    "load_net",
    "save_net",
    "TrainState",
    "make_train_step",
    "sgd_update",
    "__version__",
]
