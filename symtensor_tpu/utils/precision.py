"""Matmul precision policy for value-path dots.

On the GPU an f32 dot at DEFAULT precision may run on the tensor cores in
TF32, which keeps ~10 mantissa bits (~1e-3 relative per product); on the
CPU every precision is full f32.  Single-input evaluation lowers to GEMVs,
but under ``vmap`` or explicit batching the very same ``dot_general``
becomes a GEMM, where the reduced precision shows: it would give up ~3
digits of the reference's accuracy.

Policy implemented by :func:`value_prec` — keyed on the dtype the dot's
operands actually have:

- bf16 operands: ``None`` (the operands are already bf16; DEFAULT is both
  exact-given-the-inputs and fastest — accumulation stays f32 via
  ``preferred_element_type``).
- f32/f64 operands: ``HIGHEST``, unless the user has set the global
  ``jax_default_matmul_precision`` flag (then we respect their choice and
  pass ``None``).
- ``SYMTENSOR_VALUE_PRECISION`` ∈ {default, high, highest} overrides
  everything (measurement/escape hatch).

The explicit batched-evaluation GEMMs (``poly_eval_flat_batched*``) follow
the same policy.  Measured on one NVIDIA H100 80GB HBM3 (700 W power
limit) at rank-4 dim-100, B = 1024, f32 storage, normalized error
max|Δ|/max|y| against a float64 oracle (chip_smoke.py phase 2): HIGH (TF32
on this card) 3.64 ms warm at 1.25e-4, HIGHEST 5.14 ms at 3.0e-7, the
3-pass ``DotAlgorithmPreset.TF32_TF32_F32_X3`` 2.87 ms at 3.0e-7 but
245 s to compile cold against 20 s for HIGHEST, and rejected by XLA:CPU.
HIGHEST keeps the ~1e-5 accuracy intent on every backend with one policy;
the 3-pass preset would pay off only after ~10^5 warm calls per process
without a warm compile cache.

The reference implicitly computes everything at full NumPy f32/f64
precision (`/root/reference/symtensor/symalg.py` is plain NumPy); matching
its accuracy by default is part of parity. Users who want bf16 speed opt
in by *storing* bf16 (the premul-views batched route) or via the env knob
/ global flag.

.. caution:: **The policy is read at TRACE time and then baked into cached
   programs.** Callers are ``lru_cache``'d jitted builders keyed only on
   shape-ish arguments (rank, dim, dtype), so flipping
   ``SYMTENSOR_VALUE_PRECISION`` *after* an op has already traced is
   silently ignored for that op — the cached executable keeps whatever
   precision it was traced with.  Set the env var before first use of an
   op.  (``jax.default_matmul_precision`` is part of jit's cache key, so a
   context around the call does retrace.)
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

_ENV_MAP = {
    "default": None,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}


def value_prec(operand_dtype):
    """Precision for a dot whose operands have ``operand_dtype``."""
    dt = jnp.dtype(operand_dtype)
    if dt not in (jnp.dtype(jnp.float32), jnp.dtype(jnp.float64)):
        return None
    env = os.environ.get("SYMTENSOR_VALUE_PRECISION", "").lower()
    if env in _ENV_MAP:
        return _ENV_MAP[env]
    if jax.config.jax_default_matmul_precision is not None:
        return None  # respect the user's global choice
    return jax.lax.Precision.HIGHEST
