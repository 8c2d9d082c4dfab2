"""Host-side utilities: env-var configuration and the device, metrics,
unicode text (port of clstm_tpu/utils; reference utils.h, pstring.h).

The JAX package's ``enable_compile_cache`` has no counterpart: it turns on
XLA's compilation cache, and the port compiles nothing ahead (the CLIs
read the ``compile_cache`` variable and ignore it)."""

from clstm_tpu_torch.utils.config import getbenv, getdenv, getienv, getsenv
from clstm_tpu_torch.utils.metrics import cer, levenshtein
from clstm_tpu_torch.utils.text import read_text, split

__all__ = ["getienv", "getdenv", "getsenv", "getbenv",
           "levenshtein", "cer", "read_text", "split"]
