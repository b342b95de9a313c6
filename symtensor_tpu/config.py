"""Global configuration for symtensor-tpu.

The reference library has no config system (behavior is selected by class
choice — SURVEY.md §5); we keep that philosophy but expose a few knobs that
matter on the accelerator: default dtype, and size guards for the static
gather tables that back the generic compressed-domain ops.
"""

from __future__ import annotations

import dataclasses
import logging
import os

logger = logging.getLogger("symtensor_tpu")


@dataclasses.dataclass
class Config:
    # Default dtype for newly-created tensors. float32 is the accelerator-
    # native choice; tests that need 1e-12 agreement enable jax x64 and pass
    # float64 explicitly.
    default_dtype: str = "float32"

    # Maximum number of entries allowed in a host-built static table
    # (index tables, split tables for outer/tensordot, basis-change gathers).
    # Ops that would exceed this raise with a pointer to the streaming path.
    max_table_entries: int = 200_000_000

    # Maximum dense size (d**r) that todense()/dense fallbacks will
    # materialize before raising.
    max_dense_elements: int = 100_000_000

    # Emit a warning whenever an op falls back to a densify path.
    warn_on_densify: bool = True

    # Decomp-format addition auto-compaction: when the block-embedded
    # weights of a structural add would exceed this many elements AND the
    # exact standard-basis representation (weights = (dim,)**rank
    # coefficients, factors = identity) is smaller, the smaller form is
    # returned.  Bounds the exponential factor growth of long add/tensordot
    # chains at small dim while leaving genuinely low-rank decompositions
    # (dim**rank huge) untouched.  0 disables.
    decomp_autoreduce_elems: int = 65536


config = Config()

# Default persistent compile cache: ``.jax_cache`` beside the package.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_persistent_compile_cache() -> str | None:
    """Point JAX's persistent compilation cache at a fixed directory.

    Full-size programs (the rank-6 eval's ~100 per-group view builds, the
    blocked basis change's chunk programs) take seconds to minutes to
    compile; the cache stores each compiled executable on disk keyed by
    its HLO, so a later process loads it instead of compiling again.

    Called at package import:
    - if ``JAX_COMPILATION_CACHE_DIR`` (or ``jax_compilation_cache_dir``)
      is already set, that directory is used and no other is set;
    - otherwise the cache goes to ``<checkout>/.jax_cache``, a fixed path
      (entries in a directory that moves between runs are never found);
    - if ``jax_enable_compilation_cache`` is off (the test suite turns it
      off), nothing is set.

    Returns the cache dir in use, or None when disabled.
    """
    import jax

    if not jax.config.jax_enable_compilation_cache:
        return None
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
