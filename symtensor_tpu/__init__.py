"""symtensor-tpu: accelerator-native symmetric tensors (JAX/XLA).

A from-scratch rebuild of the capabilities of the `symtensor` reference
library (compressed symmetric-tensor storage + symmetrized linear algebra),
designed JAX-first: tensors are immutable registered pytrees with static
combinatorial index tables; ops are explicit, compressed-domain, and
jit/vmap/grad-compatible. See SURVEY.md for the reference analysis.
"""

from . import config as _config_module
from .config import config
from .config import enable_persistent_compile_cache as _enable_cc

_enable_cc()  # compiled-executable disk cache (see config.py)
from .core import (
    DecompSymmetricTensor,
    DenseSymmetricTensor,
    FlatSymmetricTensor,
    FlatSymmetricTensorSlice,
    PermClsSymmetricTensor,
    SparseFlatSymmetricTensor,
    SymmetricTensor,
)
from . import ops
from . import ops as symalg
from . import utils

__version__ = "0.2.0"

__all__ = [
    "config",
    "DecompSymmetricTensor",
    "DenseSymmetricTensor",
    "FlatSymmetricTensor",
    "FlatSymmetricTensorSlice",
    "PermClsSymmetricTensor",
    "SparseFlatSymmetricTensor",
    "SymmetricTensor",
    "ops",
    "symalg",
    "utils",
]
