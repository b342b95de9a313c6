"""Lazy partial-index views (reference FlatSymmetricTensorSlice,
flat_symtensor.py:277-354) and the experimental BCOO-backed sparse flat
format (reference sparse 1-D storage, flat_symtensor.py:80,195-200)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu import symalg
from symtensor_tpu.ops.symmetrize import symmetrize


def random_sym(rank, dim, rng):
    return np.asarray(symmetrize(rng.normal(size=(dim,) * rank)))


# ------------------------------------------------------------- lazy views


def test_partial_indexing_is_lazy(rng):
    dense = random_sym(4, 5, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    v = A[2]
    assert isinstance(v, st.FlatSymmetricTensorSlice)
    assert v._cache is None  # nothing materialized yet
    assert v.rank == 3 and v.dim == 5
    # element access goes through the parent directly (still lazy)
    np.testing.assert_allclose(float(v[0, 1, 3]), dense[2, 0, 1, 3])
    assert v._cache is None
    # deepening the view is O(1) too
    vv = v[1]
    assert isinstance(vv, st.FlatSymmetricTensorSlice)
    assert vv.fixed == (2, 1)
    np.testing.assert_allclose(
        np.asarray(vv.todense()), dense[2, 1], atol=1e-12
    )


def test_view_materializes_correctly(rng):
    dense = random_sym(3, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    for i in range(4):
        v = A[i]
        np.testing.assert_allclose(
            np.asarray(v.todense()), dense[i], atol=1e-12
        )
        # views interoperate with symalg / arithmetic like flat tensors
        w = v + v
        np.testing.assert_allclose(
            np.asarray(w.todense()), 2 * dense[i], atol=1e-12
        )
        got = float(symalg.contract_all_indices_with_vector(v, np.ones(4)))
        np.testing.assert_allclose(got, dense[i].sum(), rtol=1e-9)


def test_view_is_pytree(rng):
    dense = random_sym(3, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    v = A[1]

    @jax.jit
    def f(view):
        return view.data.sum()

    want = float(
        st.FlatSymmetricTensor.from_dense(
            jnp.asarray(dense[1]), symmetrize=True
        ).data.sum()
    )
    np.testing.assert_allclose(float(f(v)), want, rtol=1e-9)


def test_view_updates_materialize(rng):
    dense = random_sym(3, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    v = A[0].at[1, 2].set(5.0)
    assert isinstance(v, st.FlatSymmetricTensor)  # no longer a view
    np.testing.assert_allclose(float(v[1, 2]), 5.0)
    np.testing.assert_allclose(float(v[2, 1]), 5.0)  # whole class updated


# ------------------------------------------------------------ sparse flat


def test_sparse_roundtrip(rng):
    dense = random_sym(3, 5, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    S = st.SparseFlatSymmetricTensor.from_flat(A)
    assert S.nnz == A.size
    np.testing.assert_allclose(
        np.asarray(S.todense()), dense, atol=1e-12
    )
    # thresholded sparsification drops small entries
    A2 = st.FlatSymmetricTensor(
        rank=2, dim=4, data=jnp.asarray([1.0, 0.0, 0.0, 2.0] + [0.0] * 6)
    )
    S2 = st.SparseFlatSymmetricTensor.from_flat(A2, threshold=0.5)
    assert S2.nnz == 2
    assert S2.memory_footprint() < A2.memory_footprint() + 100


def test_sparse_from_entries_and_element(rng):
    # few-body tensor at a dim where even the packed axis is large
    dim, rank = 500, 3
    S = st.SparseFlatSymmetricTensor.from_entries(
        rank, dim, [(0, 1, 2), (5, 5, 7), (499, 0, 3)], [1.5, -2.0, 3.0]
    )
    assert S.nnz == 3
    np.testing.assert_allclose(float(S[2, 0, 1]), 1.5)  # any permutation
    np.testing.assert_allclose(float(S[5, 7, 5]), -2.0)
    np.testing.assert_allclose(float(S[0, 3, 499]), 3.0)
    np.testing.assert_allclose(float(S[1, 1, 1]), 0.0)  # absent → 0


def test_sparse_poly_eval(rng):
    dense = random_sym(3, 5, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    S = st.SparseFlatSymmetricTensor.from_flat(A)
    x = rng.normal(size=5)
    got = float(symalg.contract_all_indices_with_vector(S, x))
    want = float(np.einsum("ijk,i,j,k->", dense, x, x, x))
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # O(nnz) path at a dim where the dense tables would be enormous
    dim = 1000
    S2 = st.SparseFlatSymmetricTensor.from_entries(
        3, dim, [(0, 1, 2), (10, 10, 999)], [2.0, 1.0]
    )
    x = rng.normal(size=dim)
    got = float(symalg.contract_all_indices_with_vector(S2, x))
    want = 2.0 * 6 * x[0] * x[1] * x[2] + 1.0 * 3 * x[10] ** 2 * x[999]
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_sparse_arithmetic(rng):
    dense_a = random_sym(2, 4, rng)
    dense_b = random_sym(2, 4, rng)
    Sa = st.SparseFlatSymmetricTensor.from_flat(
        st.FlatSymmetricTensor.from_dense(jnp.asarray(dense_a))
    )
    Sb = st.SparseFlatSymmetricTensor.from_flat(
        st.FlatSymmetricTensor.from_dense(jnp.asarray(dense_b))
    )
    # sparse-closed ops stay sparse
    s = Sa + Sb
    assert isinstance(s, st.SparseFlatSymmetricTensor)
    np.testing.assert_allclose(
        np.asarray(s.todense()), dense_a + dense_b, atol=1e-12
    )
    m = Sa * 3.0
    assert isinstance(m, st.SparseFlatSymmetricTensor)
    np.testing.assert_allclose(
        np.asarray(m.todense()), 3 * dense_a, atol=1e-12
    )
    assert isinstance(-Sa, st.SparseFlatSymmetricTensor)
    # non-closed ops expand with a storage-densify fallback; the warning
    # is once per site per process, so forget sites other tests hit first
    from symtensor_tpu.utils import profiling

    profiling.reset_counters()
    with pytest.warns(UserWarning):
        p = Sa * Sb
    np.testing.assert_allclose(
        np.asarray(p.todense()), dense_a * dense_b, atol=1e-12
    )
