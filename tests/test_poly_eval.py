"""Grouped-GEMV kernel vs the simple EGF path and the dense oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu.kernels.poly_eval import poly_eval_flat, poly_eval_flat_batched
from symtensor_tpu.ops.contract import _contract_vec_flat_simple
from symtensor_tpu.ops.symmetrize import symmetrize


@pytest.mark.parametrize(
    "rank,dim", [(2, 5), (3, 4), (3, 7), (4, 5), (5, 4), (6, 3), (6, 5), (7, 3)]
)
def test_grouped_matches_simple_and_dense(rank, dim, rng):
    n = st.utils.indep_size(rank, dim)
    A = st.FlatSymmetricTensor(
        rank=rank, dim=dim, data=jnp.asarray(rng.normal(size=n))
    )
    x = jnp.asarray(rng.normal(size=dim))
    got = float(poly_eval_flat(A, x))
    simple = float(_contract_vec_flat_simple(A, x))
    np.testing.assert_allclose(got, simple, rtol=1e-10)
    dense = np.asarray(A.todense())
    expect = dense
    for _ in range(rank):
        expect = expect @ np.asarray(x)
    np.testing.assert_allclose(got, float(expect), rtol=1e-9)


@pytest.mark.parametrize("rank,dim", [(3, 5), (4, 4), (6, 3)])
def test_batched_matches_loop(rank, dim, rng):
    n = st.utils.indep_size(rank, dim)
    A = st.FlatSymmetricTensor(
        rank=rank, dim=dim, data=jnp.asarray(rng.normal(size=n))
    )
    xs = jnp.asarray(rng.normal(size=(6, dim)))
    got = np.asarray(poly_eval_flat_batched(A, xs))
    ref = np.array([float(poly_eval_flat(A, x)) for x in xs])
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_grouped_jit_grad(rng):
    rank, dim = 4, 6
    n = st.utils.indep_size(rank, dim)
    A = st.FlatSymmetricTensor(
        rank=rank, dim=dim, data=jnp.asarray(rng.normal(size=n))
    )
    x = jnp.asarray(rng.normal(size=dim))
    f = jax.jit(lambda A, x: poly_eval_flat(A, x))
    np.testing.assert_allclose(
        float(f(A, x)), float(poly_eval_flat(A, x)), rtol=1e-12
    )
    gx = jax.grad(lambda x: f(A, x))(x)
    dense = np.asarray(A.todense())
    expect = rank * np.einsum("abcd,b,c,d->a", dense, *([np.asarray(x)] * 3))
    np.testing.assert_allclose(np.asarray(gx), expect, rtol=1e-8)
    gA = jax.grad(lambda A: f(A, x))(A)
    assert isinstance(gA, st.FlatSymmetricTensor)
    # dL/dvals_I = r! * EGF weight — check one entry (the all-zeros index)
    np.testing.assert_allclose(
        float(gA.data[0]),
        float(x[0]) ** rank,
        rtol=1e-8,
    )


def test_fast_views_path_matches(rng):
    from symtensor_tpu.kernels.poly_eval import poly_eval_flat_fast, group_views

    rank, dim = 5, 6
    n = st.utils.indep_size(rank, dim)
    A = st.FlatSymmetricTensor(
        rank=rank, dim=dim, data=jnp.asarray(rng.normal(size=n))
    )
    x = jnp.asarray(rng.normal(size=dim))
    fast = float(poly_eval_flat_fast(A, x))
    ref = float(poly_eval_flat(A, x))
    np.testing.assert_allclose(fast, ref, rtol=1e-12)
    # views cached on the instance
    assert group_views(A) is group_views(A)
    # second call reuses the jitted evaluator
    fast2 = float(poly_eval_flat_fast(A, x))
    np.testing.assert_allclose(fast2, fast, rtol=0)


def test_bf16_storage_eval():
    # own deterministic rng: the 2e-2 bf16 tolerance is data-dependent
    # (cancellation), so this test must not share the session rng stream
    rng = np.random.default_rng(7)
    rank, dim = 4, 8
    n = st.utils.indep_size(rank, dim)
    data = jnp.asarray(rng.normal(size=n), jnp.float32)
    A32 = st.FlatSymmetricTensor._raw(rank, dim, data)
    A16 = A32.astype(jnp.bfloat16)
    x = jnp.asarray(rng.normal(size=dim), jnp.float32)
    ref = float(poly_eval_flat(A32, x))
    got = float(poly_eval_flat(A16, x))
    # bf16 storage, f32 accumulation: ~3 significant digits
    np.testing.assert_allclose(got, ref, rtol=2e-2)
    got_fast = float(
        __import__("symtensor_tpu.kernels.poly_eval", fromlist=["x"]).poly_eval_flat_fast(A16, x)
    )
    # the fast path folds the ρ2/ρ3 correction factors into the stored
    # bf16 values (one extra bf16 rounding) → bf16-epsilon-level deviation
    # from the in-jit path; both stay within the 2e-2 oracle band above
    np.testing.assert_allclose(got_fast, got, rtol=1e-3)
    np.testing.assert_allclose(got_fast, ref, rtol=2e-2)


def test_outer_grad_through_mxu_gathers():
    from symtensor_tpu.ops.symmetrize import symmetrize as symz

    # local fixed seed: the session rng's state depends on test ordering,
    # and a forward difference in f32 is draw-sensitive (round-2 flake)
    local = np.random.default_rng(42)
    dense = np.asarray(symz(local.normal(size=(4, 4))))
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense, jnp.float64))

    def loss(A):
        import symtensor_tpu.ops as symalg

        return (symalg.multiply.outer(A, A).data ** 2).sum()

    g = jax.grad(loss)(A)
    assert isinstance(g, st.FlatSymmetricTensor)
    # numeric check: central difference in f64
    eps = 1e-5
    Ap = st.FlatSymmetricTensor._raw(2, 4, A.data.at[1].add(eps))
    Am = st.FlatSymmetricTensor._raw(2, 4, A.data.at[1].add(-eps))
    num = (loss(Ap) - loss(Am)) / (2 * eps)
    np.testing.assert_allclose(float(num), float(g.data[1]), rtol=1e-6)


def test_batched_fast_views_matches(rng):
    from symtensor_tpu.kernels.poly_eval import (
        poly_eval_flat_batched,
        poly_eval_flat_batched_fast,
    )

    rank, dim = 5, 5
    n = st.utils.indep_size(rank, dim)
    A = st.FlatSymmetricTensor(
        rank=rank, dim=dim, data=jnp.asarray(rng.normal(size=n))
    )
    xs = jnp.asarray(rng.normal(size=(5, dim)))
    got = np.asarray(poly_eval_flat_batched_fast(A, xs))
    ref = np.asarray(poly_eval_flat_batched(A, xs))
    np.testing.assert_allclose(got, ref, rtol=1e-10)
