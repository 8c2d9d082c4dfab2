"""Host-side utilities: env-var configuration and the device, the kernels'
build directory (``enable_compile_cache``), metrics, unicode text (port of
clstm_tpu/utils; reference utils.h, pstring.h)."""

from clstm_tpu_torch.utils.config import (
    enable_compile_cache, getbenv, getdenv, getienv, getsenv)
from clstm_tpu_torch.utils.metrics import cer, levenshtein
from clstm_tpu_torch.utils.text import read_text, split

__all__ = ["getienv", "getdenv", "getsenv", "getbenv",
           "enable_compile_cache", "levenshtein", "cer", "read_text",
           "split"]
