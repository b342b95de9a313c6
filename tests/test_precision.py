"""Matmul-precision policy regression tests.

Background: on the GPU an f32 dot at DEFAULT precision may run in TF32
(~1e-3 relative). Eager single-input contractions lower to GEMVs, but
``jit(vmap(contract_all_indices_with_vector))`` and the explicit batched
kernel turn the same dots into GEMMs, where that precision loss shows
(measured on an H100 at rank-4 dim-100 B=1024: HIGH, which is TF32 there,
gave normalized error 1.25e-4 against a float64 oracle, HIGHEST 3.0e-7).

CPU executes every precision in full f32, so these tests assert the
*policy* and the *lowered HLO*, not numerics: the vmapped program must
carry operand_precision HIGHEST on its dots.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu import symalg
from symtensor_tpu.testing.utils import random_symmetric
from symtensor_tpu.utils.precision import value_prec


def _make(rank, dim, rng, dtype, fmt):
    dense = random_symmetric(rank, dim, rng=rng, dtype=np.float64)
    A = st.FlatSymmetricTensor.from_dense(np.asarray(dense, dtype=dtype))
    return A.topermcls() if fmt == "permcls" else A


def test_policy_defaults(monkeypatch):
    monkeypatch.delenv("SYMTENSOR_VALUE_PRECISION", raising=False)
    assert value_prec(jnp.float32) == jax.lax.Precision.HIGHEST
    assert value_prec(jnp.float64) == jax.lax.Precision.HIGHEST
    assert value_prec(jnp.bfloat16) is None
    assert value_prec(jnp.int32) is None


def test_batched_policy_defaults(monkeypatch):
    # explicit batched GEMMs follow value_prec: HIGHEST for f32 (on an
    # H100 at rank-4 dim-100 B=1024: 5.14 ms at normalized error 3.0e-7;
    # HIGH is TF32 there, 1.25e-4), DEFAULT for bf16 operands
    import symtensor_tpu.kernels.poly_eval as pe

    monkeypatch.delenv("SYMTENSOR_VALUE_PRECISION", raising=False)
    assert pe.value_prec is value_prec
    assert value_prec(jnp.float32) == jax.lax.Precision.HIGHEST
    assert value_prec(jnp.bfloat16) is None
    monkeypatch.setenv("SYMTENSOR_VALUE_PRECISION", "high")
    assert value_prec(jnp.float32) == jax.lax.Precision.HIGH


def test_policy_env_override(monkeypatch):
    monkeypatch.setenv("SYMTENSOR_VALUE_PRECISION", "default")
    assert value_prec(jnp.float32) is None
    monkeypatch.setenv("SYMTENSOR_VALUE_PRECISION", "high")
    assert value_prec(jnp.float32) == jax.lax.Precision.HIGH
    monkeypatch.setenv("SYMTENSOR_VALUE_PRECISION", "highest")
    assert value_prec(jnp.bfloat16) is None  # bf16 stays fast either way


def test_policy_respects_global_flag(monkeypatch):
    monkeypatch.delenv("SYMTENSOR_VALUE_PRECISION", raising=False)
    jax.config.update("jax_default_matmul_precision", "bfloat16")
    try:
        assert value_prec(jnp.float32) is None
    finally:
        jax.config.update("jax_default_matmul_precision", None)


def _assert_all_dots_highest(hlo: str):
    """Every dot in the lowered StableHLO must carry HIGHEST precision.

    lower().as_text() emits StableHLO ops like
      %5 = stablehlo.dot_general %a, %b, ..., precision = [HIGHEST, HIGHEST]
    DEFAULT-precision dots print no precision attribute.  Matching the
    op name (not legacy HLO " dot(" syntax, which never appears) and
    requiring a nonzero match count keeps this assertion from going
    vacuous if the text format shifts again."""
    dot_lines = [ln for ln in hlo.splitlines() if "dot_general" in ln]
    assert dot_lines, "no dot_general ops found in lowered program"
    for line in dot_lines:
        assert "HIGHEST" in line, line


@pytest.mark.parametrize("fmt", ["flat", "permcls"])
def test_vmapped_eval_hlo_carries_highest(fmt, rng):
    r, d = 4, 6
    A = _make(r, d, rng, jnp.float32, fmt)
    xs = jnp.asarray(rng.normal(size=(3, d)), dtype=jnp.float32)
    f = jax.jit(
        lambda xb: jax.vmap(
            lambda xi: symalg.contract_all_indices_with_vector(A, xi)
        )(xb)
    )
    _assert_all_dots_highest(f.lower(xs).as_text())


def test_batched_kernel_hlo_carries_high(rng):
    """The explicit batched kernel's dots carry HIGHEST (value_prec) —
    never DEFAULT, which may run f32 operands in TF32 on the GPU."""
    from symtensor_tpu.kernels.poly_eval import poly_eval_flat_batched

    r, d = 4, 6
    A = _make(r, d, rng, jnp.float32, "flat")
    xs = jnp.asarray(rng.normal(size=(8, d)), dtype=jnp.float32)
    hlo = jax.jit(lambda xb: poly_eval_flat_batched(A, xb)).lower(xs).as_text()
    _assert_all_dots_highest(hlo)


def test_sharded_batched_eval_hlo_carries_highest(rng):
    """The dp×tp colex evaluation's dots (forward and gradient) carry
    HIGHEST like the one-device path; at DEFAULT the GPU may run them in
    TF32."""
    from symtensor_tpu import parallel

    mesh = parallel.make_mesh((2, 2), ("dp", "tp"))
    r, d = 3, 5
    A = _make(r, d, rng, jnp.float32, "flat")
    xs = jnp.asarray(rng.normal(size=(4, d)), dtype=jnp.float32)
    f = jax.jit(jax.grad(
        lambda data: parallel.poly_eval_batched_sharded(
            st.FlatSymmetricTensor._raw(r, d, data), xs, mesh
        ).sum()
    ))
    _assert_all_dots_highest(f.lower(A.data).as_text())


def test_vmapped_matches_eager(rng):
    """On CPU the numerics agree at any precision; this pins the vmapped
    path to the eager one so routing changes can't silently diverge."""
    r, d = 4, 8
    A = _make(r, d, rng, jnp.float64, "flat")
    xs = rng.normal(size=(4, d))
    eager = np.array(
        [float(symalg.contract_all_indices_with_vector(A, x)) for x in xs]
    )
    jv = np.asarray(
        jax.jit(
            lambda xb: jax.vmap(
                lambda xi: symalg.contract_all_indices_with_vector(A, xi)
            )(xb)
        )(jnp.asarray(xs))
    )
    np.testing.assert_allclose(jv, eager, rtol=1e-10)
