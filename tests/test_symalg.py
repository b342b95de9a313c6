"""Symmetrized-algebra tests. Universal oracle: densify, apply the NumPy op,
symmetrize (the reference's generic implementation, symalg.py:206)."""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu import symalg
from symtensor_tpu.ops.symmetrize import symmetrize
from symtensor_tpu.utils import combinatorics as comb

FORMATS = [
    st.DenseSymmetricTensor,
    st.FlatSymmetricTensor,
    st.PermClsSymmetricTensor,
]


def random_sym(rank, dim, rng):
    if rank == 0:
        return np.asarray(rng.normal())
    return np.asarray(symmetrize(rng.normal(size=(dim,) * rank)))


def sym_np(arr):
    return np.asarray(symmetrize(np.asarray(arr)))


@pytest.fixture(params=FORMATS, ids=lambda c: c.format)
def fmt(request):
    return request.param


# ------------------------------------------------------------- symmetrize


def test_symmetrize_matches_bruteforce(rng):
    for rank, dim in [(2, 4), (3, 3), (4, 3), (5, 2)]:
        a = rng.normal(size=(dim,) * rank)
        brute = np.zeros_like(a)
        for p in itertools.permutations(range(rank)):
            brute += np.transpose(a, p)
        brute /= math.factorial(rank)
        np.testing.assert_allclose(np.asarray(symmetrize(a)), brute, atol=1e-12)
        # idempotent
        np.testing.assert_allclose(
            np.asarray(symmetrize(symmetrize(a))),
            np.asarray(symmetrize(a)),
            atol=1e-12,
        )


# ------------------------------------------------------------------ outer


@pytest.mark.parametrize("ra,rb,dim", [(1, 1, 4), (2, 1, 3), (2, 2, 3), (3, 2, 3), (1, 3, 2)])
def test_multiply_outer(fmt, ra, rb, dim, rng):
    da, db = random_sym(ra, dim, rng), random_sym(rb, dim, rng)
    A, B = fmt.from_dense(da), fmt.from_dense(db)
    out = symalg.multiply.outer(A, B)
    oracle = sym_np(np.multiply.outer(da, db))
    assert isinstance(out, st.SymmetricTensor)
    assert out.rank == ra + rb and out.dim == dim
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-10)
    # result format follows operands
    assert out.format == fmt.format


@pytest.mark.parametrize("name,np_ufunc", [("add", np.add), ("subtract", np.subtract)])
def test_add_subtract_outer(fmt, name, np_ufunc, rng):
    da, db = random_sym(2, 3, rng), random_sym(1, 3, rng)
    A, B = fmt.from_dense(da), fmt.from_dense(db)
    out = getattr(symalg, name).outer(A, B)
    oracle = sym_np(np_ufunc.outer(da, db))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-10)


def test_outer_with_scalars(fmt, rng):
    da = random_sym(2, 3, rng)
    A = fmt.from_dense(da)
    out = symalg.multiply.outer(A, 2.0)
    np.testing.assert_allclose(np.asarray(out.todense()), 2 * da, atol=1e-12)
    out2 = symalg.multiply.outer(3.0, A)
    np.testing.assert_allclose(np.asarray(out2.todense()), 3 * da, atol=1e-12)


def test_outer_with_vector_operand(fmt, rng):
    da = random_sym(2, 3, rng)
    v = rng.normal(size=3)
    A = fmt.from_dense(da)
    out = symalg.multiply.outer(A, v)
    oracle = sym_np(np.multiply.outer(da, v))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-10)


def test_outer_dim_mismatch(fmt):
    A = fmt.zeros(2, 3)
    B = fmt.zeros(1, 4)
    with pytest.raises(ValueError):
        symalg.multiply.outer(A, B)


# -------------------------------------------------------------- tensordot


@pytest.mark.parametrize(
    "ra,rb,k,dim",
    [
        (1, 1, 1, 4),
        (2, 1, 1, 3),
        (2, 2, 1, 3),
        (2, 2, 2, 3),
        (3, 2, 1, 3),
        (3, 2, 2, 3),
        (3, 3, 2, 2),
        (4, 2, 2, 2),
    ],
)
def test_tensordot(fmt, ra, rb, k, dim, rng):
    da, db = random_sym(ra, dim, rng), random_sym(rb, dim, rng)
    A, B = fmt.from_dense(da), fmt.from_dense(db)
    out = symalg.tensordot(A, B, axes=k)
    oracle = sym_np(np.tensordot(da, db, axes=k))
    if ra + rb - 2 * k == 0:
        np.testing.assert_allclose(float(out.todense()), oracle, atol=1e-10)
    else:
        np.testing.assert_allclose(
            np.asarray(out.todense()), oracle, atol=1e-10
        )


def test_tensordot_axes_forms(fmt, rng):
    da, db = random_sym(2, 3, rng), random_sym(2, 3, rng)
    A, B = fmt.from_dense(da), fmt.from_dense(db)
    r_int = symalg.tensordot(A, B, axes=1)
    r_list = symalg.tensordot(A, B, axes=([1], [0]))
    assert r_int.allclose(r_list)
    with pytest.raises(ValueError):
        symalg.tensordot(A, B, axes=3)


def test_tensordot_with_plain_vector(fmt, rng):
    da = random_sym(3, 3, rng)
    x = rng.normal(size=3)
    A = fmt.from_dense(da)
    out = symalg.tensordot(A, x, axes=1)
    oracle = sym_np(np.tensordot(da, x, axes=1))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-10)


def test_transpose_noop(fmt, rng):
    A = fmt.from_dense(random_sym(2, 3, rng))
    assert symalg.transpose(A) is A


# ---------------------------------------------- contract with vector/matrix


@pytest.mark.parametrize("rank,dim", [(1, 5), (2, 4), (3, 4), (4, 3), (5, 3), (6, 2)])
def test_contract_all_indices_with_vector(fmt, rank, dim, rng):
    dense = random_sym(rank, dim, rng)
    x = rng.normal(size=dim)
    A = fmt.from_dense(dense)
    got = symalg.contract_all_indices_with_vector(A, x)
    expect = dense
    for _ in range(rank):
        expect = expect @ x
    np.testing.assert_allclose(float(got), expect, rtol=1e-10)


def test_contract_vector_under_jit_vmap_grad(fmt, rng):
    dense = random_sym(3, 4, rng)
    A = fmt.from_dense(dense)

    f = jax.jit(lambda t, x: symalg.contract_all_indices_with_vector(t, x))
    x = jnp.asarray(rng.normal(size=4))
    expect = np.einsum("ijk,i,j,k->", dense, x, x, x)
    np.testing.assert_allclose(float(f(A, x)), expect, rtol=1e-10)

    xs = jnp.asarray(rng.normal(size=(7, 4)))
    batched = jax.vmap(lambda x: f(A, x))(xs)
    expect_b = np.einsum("ijk,bi,bj,bk->b", dense, xs, xs, xs)
    np.testing.assert_allclose(np.asarray(batched), expect_b, rtol=1e-9)

    # gradient wrt x: ∇ = r · contraction with r-1 copies
    g = jax.grad(lambda x: f(A, x))(x)
    expect_g = 3 * np.einsum("ijk,j,k->i", dense, x, x)
    np.testing.assert_allclose(np.asarray(g), expect_g, rtol=1e-9)


def test_contract_vector_scalar_classes(rng):
    """Power-sum fast path: scalar-compressed classes at a dim too large to
    enumerate (the rank-6 dim-200 BASELINE config, scaled down in rank)."""
    dim = 200
    A = st.PermClsSymmetricTensor(
        rank=4, dim=dim, data={"iiii": 0.5, "iijj": -1.25, "ijkl": 2.0}
    )
    x = rng.normal(size=dim)
    got = float(symalg.contract_all_indices_with_vector(A, x))
    # oracle via monomial sums computed directly
    p1, p2 = x.sum(), (x**2).sum()
    p3, p4 = (x**3).sum(), (x**4).sum()
    m_iiii = p4
    # m_{2,2} = (p2^2 - p4)/2
    m_iijj = (p2**2 - p4) / 2
    # m_{1,1,1,1} = (p1^4 - 6 p1^2 p2 + 3 p2^2 + 8 p1 p3 - 6 p4)/24
    m_ijkl = (p1**4 - 6 * p1**2 * p2 + 3 * p2**2 + 8 * p1 * p3 - 6 * p4) / 24
    expect = (
        0.5 * 1 * m_iiii + (-1.25) * comb.class_multiplicity((2, 2)) * m_iijj
        + 2.0 * comb.class_multiplicity((1, 1, 1, 1)) * m_ijkl
    )
    np.testing.assert_allclose(got, expect, rtol=1e-9)


def test_contract_vector_mixed_scalar_vector_classes(rng):
    dim = 6
    n_iij = comb.class_size((2, 1), dim)
    A = st.PermClsSymmetricTensor(
        rank=3,
        dim=dim,
        data={"iii": 1.5, "iij": jnp.asarray(rng.normal(size=n_iij))},
        dtype=jnp.float64,
    )
    x = rng.normal(size=dim)
    got = float(symalg.contract_all_indices_with_vector(A, x))
    dense = np.asarray(A.todense())
    expect = np.einsum("ijk,i,j,k->", dense, x, x, x)
    np.testing.assert_allclose(got, expect, rtol=1e-9)


@pytest.mark.parametrize("rank,dim,dim_out", [(1, 4, 4), (2, 4, 4), (3, 3, 3), (4, 3, 3), (3, 3, 5), (2, 3, 2)])
def test_contract_all_indices_with_matrix(fmt, rank, dim, dim_out, rng):
    dense = random_sym(rank, dim, rng)
    W = rng.normal(size=(dim, dim_out))
    A = fmt.from_dense(dense)
    out = symalg.contract_all_indices_with_matrix(A, W)
    assert out.rank == rank and out.dim == dim_out
    args = [dense] + [W] * rank
    letters_in = "abcdefgh"[:rank]
    letters_out = "ijklmnop"[:rank]
    spec = (
        letters_in
        + ","
        + ",".join(f"{i}{o}" for i, o in zip(letters_in, letters_out))
        + "->"
        + letters_out
    )
    oracle = np.einsum(spec, *args)
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-9)
    assert out.format == fmt.format


def test_basis_change_jit_grad(rng):
    dense = random_sym(3, 3, rng)
    A = st.FlatSymmetricTensor.from_dense(dense)
    W = jnp.asarray(rng.normal(size=(3, 3)))

    f = jax.jit(
        lambda t, w: symalg.contract_all_indices_with_matrix(t, w).data.sum()
    )
    v1 = float(f(A, W))
    g = jax.grad(f, argnums=1)(A, W)
    assert g.shape == (3, 3)
    # numeric check of one gradient entry
    eps = 1e-6
    W2 = W.at[0, 1].add(eps)
    np.testing.assert_allclose(
        float((f(A, W2) - v1) / eps), float(g[0, 1]), rtol=1e-3
    )


# --------------------------------------------------- contract_tensor_list


def oracle_contract_tensor_list(dense, chis, n_times, values):
    """Brute-force reference: loop index tuples, nested outer, symmetrize."""
    d = dense.shape[0]
    m = chis[0].ndim
    r = dense.ndim
    out_rank = r - n_times + n_times * m
    out = np.zeros((d,) * out_rank)
    for idx in itertools.product(values, repeat=n_times):
        term = dense[idx]
        for i in idx:
            term = np.multiply.outer(term, chis[i])
        out += term
    return sym_np(out)


@pytest.mark.parametrize(
    "r,m,n_times",
    [(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (3, 1, 1), (2, 1, 2),
     (3, 2, 2), (3, 1, 3), (4, 1, 3), (4, 1, 4)],
)
def test_contract_tensor_list(fmt, r, m, n_times, rng):
    dim = 3
    dense = random_sym(r, dim, rng)
    chis = [random_sym(m, dim, rng) for _ in range(dim)]
    A = fmt.from_dense(dense)
    chi_ts = [fmt.from_dense(c) for c in chis]
    out = symalg.contract_tensor_list(A, chi_ts, n_times=n_times)
    assert out.rank == r - n_times + n_times * m
    oracle = oracle_contract_tensor_list(dense, chis, n_times, range(dim))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-9)


def test_contract_tensor_list_second_half(rng):
    dim = 4
    dense = random_sym(2, dim, rng)
    chis = [random_sym(1, dim, rng) for _ in range(dim)]
    A = st.FlatSymmetricTensor.from_dense(dense)
    chi_ts = [st.FlatSymmetricTensor.from_dense(c) for c in chis]
    out = symalg.contract_tensor_list(A, chi_ts, rule="second_half")
    oracle = oracle_contract_tensor_list(dense, chis, 1, range(2, 4))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-9)


def test_contract_tensor_list_validation(fmt):
    A = fmt.zeros(2, 3)
    chis = [fmt.zeros(1, 3)] * 3
    with pytest.raises(ValueError):
        symalg.contract_tensor_list(A, chis, n_times=3)
    with pytest.raises(ValueError):
        symalg.contract_tensor_list(A, chis[:2])
    with pytest.raises(ValueError):
        symalg.contract_tensor_list(A, [fmt.zeros(1, 3), fmt.zeros(1, 3), fmt.zeros(2, 3)])


# -------------------------------------------------- monomial symmetric


def test_monomial_symmetric_bruteforce(rng):
    x = rng.normal(size=5)
    for lam in [(1,), (2,), (1, 1), (2, 1), (3, 2, 1), (2, 2), (1, 1, 1)]:
        got = float(symalg.monomial_symmetric(lam, x))
        # brute force over distinct value assignments
        L = len(lam)
        total = 0.0
        for vals in itertools.permutations(range(5), L):
            total += np.prod([x[v] ** c for v, c in zip(vals, lam)])
        # ordered assignments overcount by ∏ m_n! (equal parts interchange)
        from collections import Counter

        denom = 1
        for mcount in Counter(lam).values():
            denom *= math.factorial(mcount)
        np.testing.assert_allclose(got, total / denom, rtol=1e-9)


def test_batched_contract_all_formats(rng):
    dim, B = 5, 7
    xs = jnp.asarray(rng.normal(size=(B, dim)))
    dense = random_sym(3, dim, rng)
    expect = np.einsum("ijk,bi,bj,bk->b", dense, *([np.asarray(xs)] * 3))
    for fmt in FORMATS:
        A = fmt.from_dense(dense)
        got = np.asarray(symalg.contract_all_indices_with_vector_batched(A, xs))
        np.testing.assert_allclose(got, expect, rtol=1e-9, err_msg=fmt.format)
    # decomp
    D = st.DecompSymmetricTensor(
        rank=3, dim=dim,
        weights=jnp.asarray(rng.normal(size=(2, 2))),
        factors=jnp.asarray(rng.normal(size=(2, dim))),
        multiplicities=(2, 1), dtype=jnp.float64,
    )
    got = np.asarray(symalg.contract_all_indices_with_vector_batched(D, xs))
    ref = np.array([
        float(symalg.contract_all_indices_with_vector(D, x)) for x in xs
    ])
    np.testing.assert_allclose(got, ref, rtol=1e-9)


def test_permcls_per_class_contraction_path(rng):
    # vector + scalar classes mixed, checked against dense, at float64
    dim = 7
    n_iij = comb.class_size((2, 1), dim)
    n_ijk = comb.class_size((1, 1, 1), dim)
    A = st.PermClsSymmetricTensor(
        rank=3, dim=dim,
        data={"iii": 0.5,
              "iij": jnp.asarray(rng.normal(size=n_iij)),
              "ijk": jnp.asarray(rng.normal(size=n_ijk))},
        dtype=jnp.float64,
    )
    x = rng.normal(size=dim)
    got = float(symalg.contract_all_indices_with_vector(A, x))
    dense = np.asarray(A.todense())
    expect = np.einsum("ijk,i,j,k->", dense, x, x, x)
    np.testing.assert_allclose(got, expect, rtol=1e-10)


def test_isclose_elementwise(rng):
    da = random_sym(2, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(da)
    B = A.at[0, 1].add(1.0)
    close = symalg.isclose(A, B)
    vals = np.asarray(close.data)
    assert vals.dtype == bool
    assert vals.sum() == len(vals) - 1  # exactly one component differs
    allc = symalg.isclose(A, A)
    assert np.asarray(allc.data).all()
    sc = symalg.isclose(A, 0.0)
    assert np.asarray(sc.data).dtype == bool


def test_basis_change_small_route_matches_blocked(rng):
    """Default (all-default args, no env tuning) invocations take the
    whole-op jitted small route; explicit budgets take the blocked
    recursion.  Both must agree with each other and the einsum oracle."""
    from symtensor_tpu.ops.basis_change import (
        _SMALL_JIT_CACHE,
        _small_peak_elems,
        basis_change_packed,
    )

    dense = random_sym(4, 7, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = jnp.asarray(rng.normal(size=(7, 6)))
    assert _small_peak_elems(4, 7, 6, 2**26) <= 2**28  # routes small
    n_cached = len(_SMALL_JIT_CACHE)
    small = basis_change_packed(A, W)
    assert len(_SMALL_JIT_CACHE) >= n_cached  # route taken (fn built/reused)
    blocked = basis_change_packed(A, W, block_elems=5000, transient_elems=4096)
    np.testing.assert_allclose(
        np.asarray(small.data), np.asarray(blocked.data), atol=1e-10
    )
    oracle = np.einsum(
        "abcd,ai,bj,ck,dl->ijkl", dense, *([np.asarray(W)] * 4)
    )
    np.testing.assert_allclose(np.asarray(small.todense()), oracle, atol=1e-9)


def test_basis_change_chunked_matches(rng, monkeypatch):
    monkeypatch.setenv("SYMTENSOR_BASIS_BLOCK_ELEMS", "1024")
    monkeypatch.setenv("SYMTENSOR_BASIS_TRANSIENT_ELEMS", "2048")
    dense = random_sym(4, 8, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = jnp.asarray(rng.normal(size=(8, 8)))
    out = symalg.contract_all_indices_with_matrix(A, W)
    oracle = np.einsum("abcd,ai,bj,ck,dl->ijkl", dense, *([np.asarray(W)] * 4))
    np.testing.assert_allclose(np.asarray(out.todense()), oracle, atol=1e-9)


def test_basis_change_inflight_throttle(rng, monkeypatch):
    """The round-5 dispatch throttle: tiny budget → many drains; huge
    budget → none.  Results identical either way."""
    from symtensor_tpu.ops import basis_change as bc

    dense = random_sym(4, 8, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = jnp.asarray(rng.normal(size=(8, 8)))

    monkeypatch.setenv("SYMTENSOR_BASIS_INFLIGHT_BYTES", "1")
    tight = bc.basis_change_packed(
        A, W, block_elems=1024, transient_elems=2048
    )
    thr_tight = bc._LAST_THROTTLE
    assert thr_tight.fences > 0
    assert thr_tight.fences <= thr_tight.adds

    monkeypatch.setenv("SYMTENSOR_BASIS_INFLIGHT_BYTES", str(1 << 60))
    loose = bc.basis_change_packed(
        A, W, block_elems=1024, transient_elems=2048
    )
    thr_loose = bc._LAST_THROTTLE
    # ≤1: the root-kernel path keeps one unconditional fence before
    # freeing the group blocks at its last window
    assert thr_loose.fences <= 1
    assert thr_loose.adds == thr_tight.adds  # same schedule
    np.testing.assert_allclose(
        np.asarray(tight.data), np.asarray(loose.data), atol=1e-9
    )
    # legacy attribution mode drains on a count cadence
    monkeypatch.setenv("SYMTENSOR_BASIS_FENCE_EVERY", "2")
    bc.basis_change_packed(A, W, block_elems=1024, transient_elems=2048)
    thr_leg = bc._LAST_THROTTLE
    assert thr_leg.every == 2
    assert thr_leg.fences >= thr_leg.adds // 2 - 1


@pytest.mark.parametrize("max_segs", [1, 2, 5])
def test_basis_change_column_windowing(rng, max_segs, monkeypatch):
    """Host-level column windowing of long step kernels (the rank-6 t=0
    root pass runs as several window programs) must be exact: windows slice the child-column
    axis, positions stay absolute, outputs reassemble npar-major."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    monkeypatch.setenv("SYMTENSOR_BASIS_MAX_SEGS", str(max_segs))
    dense = random_sym(4, 5, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    for d_out in (3, 5):
        W = rng.normal(size=(5, d_out))
        got = basis_change_packed(
            A,
            jnp.asarray(W),
            block_elems=600,
            # small transient ⇒ small seg ⇒ nseg_tot > max_segs at
            # every non-leaf level ⇒ windowing exercised throughout
            transient_elems=64,
        )
        oracle = np.einsum("abcd,ai,bj,ck,dl->ijkl", dense, W, W, W, W)
        np.testing.assert_allclose(
            np.asarray(got.todense()),
            sym_np(oracle),
            atol=1e-9,
        )


@pytest.mark.parametrize("transient", [215_000, 300_000])
def test_basis_change_wide_seg_select(rng, transient):
    """The seg > 64 select path (product grid computed directly in
    (wp, npar, seg) layout, children picked by contiguous row gather)
    must be exact, single- and multi-segment, including nsel_pad ≥ 128
    child chunks."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    dim = 70  # n_k = 70 at the t=1 step ⇒ seg > 64 there
    dense = random_sym(3, dim, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = rng.normal(size=(dim, 8))
    got = basis_change_packed(
        A,
        jnp.asarray(W),
        block_elems=60_000,
        transient_elems=transient,
    )
    oracle = np.einsum("abc,ai,bj,ck->ijk", dense, W, W, W)
    np.testing.assert_allclose(
        np.asarray(got.todense()), sym_np(oracle), atol=1e-8
    )


@pytest.mark.parametrize(
    "rank,dim,row_w",
    [
        pytest.param(5, 6, 2, marks=pytest.mark.slow),  # ~50 s
        (5, 6, 5),
        pytest.param(6, 4, 3, marks=pytest.mark.slow),  # ~40 s
    ],
)
def test_basis_change_per_row_path(rng, rank, dim, row_w, monkeypatch):
    """Per-parent-row case-kernel scheduling of wide mid levels (k ≥ 3)
    must be exact: each parent row is split into gflat group blocks and
    swept by the case-decomposed root kernel over w-wide b-windows of
    its own children.  Forced on via SYMTENSOR_BASIS_ROW_INCID=1; row_w
    below d_out exercises multi-window rows and the overhang window."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    monkeypatch.setenv("SYMTENSOR_BASIS_ROW_INCID", "1")
    monkeypatch.setenv("SYMTENSOR_BASIS_ROW_WINDOW", str(row_w))
    dense = random_sym(rank, dim, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    subs = "abcdef"[:rank]
    outs = "ijklmn"[:rank]
    spec = (
        subs + "," + ",".join(f"{s}{o}" for s, o in zip(subs, outs))
        + "->" + outs
    )
    for d_out in (dim - 1, dim, dim + 1):
        W = rng.normal(size=(dim, d_out))
        got = basis_change_packed(
            A,
            jnp.asarray(W),
            block_elems=4000,
            transient_elems=4096,
        )
        oracle = np.einsum(spec, dense, *([W] * rank))
        np.testing.assert_allclose(
            np.asarray(got.todense()), sym_np(oracle), atol=1e-9
        )


@pytest.mark.parametrize(
    "block_elems,transient_elems", [(17, 23), (64, 32), (500, 4096)]
)
def test_basis_change_blocked_budget_sweep(rng, block_elems, transient_elems):
    """The depth-first blocked recursion must be exact at ANY budget — a
    window that overhangs d_out once silently shifted the W columns
    (dynamic_slice clamping), caught by this sweep."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    dense = random_sym(3, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    for d_out in (2, 4, 5):
        W = rng.normal(size=(4, d_out))
        got = basis_change_packed(
            A,
            jnp.asarray(W),
            block_elems=block_elems,
            transient_elems=transient_elems,
        )
        oracle = np.einsum("abc,ai,bj,ck->ijk", dense, W, W, W)
        np.testing.assert_allclose(
            np.asarray(got.todense()),
            sym_np(oracle),
            atol=1e-9,
        )


@pytest.mark.parametrize(
    "ra,rb,k,dim",
    [(2, 2, 1, 4), (3, 2, 1, 3), (3, 3, 2, 3), (2, 2, 2, 3), (2, 1, 0, 4)],
)
def test_tensordot_streamed_matches(ra, rb, k, dim, rng):
    """The blocked streaming path (used past the table guard) must agree
    with the table path and the dense oracle (the
    guard used to raise MemoryError with no path behind it)."""
    from symtensor_tpu.ops.outer import symmetric_outer

    da, db = random_sym(ra, dim, rng), random_sym(rb, dim, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(da))
    B = st.FlatSymmetricTensor.from_dense(jnp.asarray(db))
    got = symalg.tensordot(A, B, axes=k, stream=True)
    want = symalg.tensordot(A, B, axes=k, stream=False)
    oracle = sym_np(np.tensordot(da, db, axes=k))
    np.testing.assert_allclose(np.asarray(got.todense()), oracle, atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(got.todense()), np.asarray(want.todense()), atol=1e-12
    )
    for fn, np_ufunc in [
        ("multiply", np.multiply),
        ("add", np.add),
        ("subtract", np.subtract),
    ]:
        got_o = symmetric_outer(A, B, fn, stream=True)
        np.testing.assert_allclose(
            np.asarray(got_o.todense()),
            sym_np(np_ufunc.outer(da, db)),
            atol=1e-10,
        )


def test_tensordot_streamed_small_blocks(rng, monkeypatch):
    """Many tiny lax.map blocks (padding included) stay exact."""
    monkeypatch.setenv("SYMTENSOR_STREAM_BLOCK_ELEMS", "64")
    da, db = random_sym(3, 4, rng), random_sym(2, 4, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(da))
    B = st.FlatSymmetricTensor.from_dense(jnp.asarray(db))
    got = symalg.tensordot(A, B, axes=1, stream=True)
    oracle = sym_np(np.tensordot(da, db, axes=1))
    np.testing.assert_allclose(np.asarray(got.todense()), oracle, atol=1e-10)


def test_basis_change_onthefly_positions(rng):
    """Force the closed-form (no materialized insert table) kernel path and
    check exactness — this is the path the rank-6 dim-100 flagship uses."""
    from symtensor_tpu.ops import basis_change as bc

    dense = random_sym(4, 6, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = rng.normal(size=(6, 6))
    got = bc.basis_change_packed(A, jnp.asarray(W), onthefly_above=0)
    oracle = np.einsum("abcd,ai,bj,ck,dl->ijkl", dense, *([W] * 4))
    np.testing.assert_allclose(
        np.asarray(got.todense()), oracle, atol=1e-9
    )


def test_permcls_contraction_fallback_no_double_count(rng, monkeypatch):
    """Regression: MemoryError mid-loop must not double-count the classes
    already evaluated through per-class tables."""
    from symtensor_tpu.config import config as cfg

    dim = 7
    n_iij = comb.class_size((2, 1), dim)
    n_ijk = comb.class_size((1, 1, 1), dim)
    A = st.PermClsSymmetricTensor(
        rank=3, dim=dim,
        data={"iij": jnp.asarray(rng.normal(size=n_iij)),
              "ijk": jnp.asarray(rng.normal(size=n_ijk))},
        dtype=jnp.float64,
    )
    x = rng.normal(size=dim)
    want = float(symalg.contract_all_indices_with_vector(A, x))
    # force the fallback after the first class by shrinking the table guard
    # (class_rep tables are cached per (rank,dim) — use a fresh dim to avoid
    # cache hits)
    dim2 = 9
    n_iij2 = comb.class_size((2, 1), dim2)
    n_ijk2 = comb.class_size((1, 1, 1), dim2)
    B = st.PermClsSymmetricTensor(
        rank=3, dim=dim2,
        data={"iij": jnp.asarray(rng.normal(size=n_iij2)),
              "ijk": jnp.asarray(rng.normal(size=n_ijk2))},
        dtype=jnp.float64,
    )
    x2 = rng.normal(size=dim2)
    dense = np.asarray(B.todense())
    expect = np.einsum("ijk,i,j,k->", dense, x2, x2, x2)
    monkeypatch.setattr(
        cfg, "max_table_entries", n_iij2 * 3 + 1
    )  # first class fits, second does not
    got = float(symalg.contract_all_indices_with_vector(B, x2))
    np.testing.assert_allclose(got, expect, rtol=1e-10)


def test_batched_contract_dim_mismatch():
    A = st.FlatSymmetricTensor.zeros(3, 5)
    with pytest.raises(ValueError):
        symalg.contract_all_indices_with_vector_batched(A, jnp.ones((2, 3)))


def test_rank0_broadcast_all_formats(rng):
    dense = random_sym(2, 3, rng)
    for fmt in FORMATS:
        A = fmt.from_dense(dense)
        s = fmt.from_dense(np.asarray(2.0))
        out = A + s
        np.testing.assert_allclose(
            np.asarray(out.todense()), dense + 2.0, atol=1e-12,
            err_msg=fmt.format,
        )
    # rank-0 permcls built via topermcls
    s0 = st.FlatSymmetricTensor.from_dense(np.asarray(3.0)).topermcls()
    A = st.FlatSymmetricTensor.from_dense(dense)
    np.testing.assert_allclose(
        np.asarray((A * s0).todense()), 3 * dense, atol=1e-12
    )


def test_scalar_outer_order(rng):
    da = random_sym(2, 3, rng)
    A = st.FlatSymmetricTensor.from_dense(da)
    out = symalg.subtract.outer(2.0, A)
    np.testing.assert_allclose(np.asarray(out.todense()), 2.0 - da, atol=1e-12)
    out = symalg.subtract.outer(A, 2.0)
    np.testing.assert_allclose(np.asarray(out.todense()), da - 2.0, atol=1e-12)


def test_fallback_counters(rng):
    from symtensor_tpu.utils import profiling

    profiling.reset_counters()
    da = random_sym(2, 3, rng)
    D = st.DecompSymmetricTensor.from_matrix(jnp.asarray(da), cutoff=0.0)
    F = st.FlatSymmetricTensor.from_dense(da)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _ = D * F  # decomp expands to packed
    assert profiling.op_counters["elementwise.decomp_to_flat"] >= 1
    profiling.reset_counters()
    assert not profiling.op_counters


def test_outer_integer_dtype(rng):
    """Integer packed tensors must not route through the float-weighted
    gather kernel (regression: silent zeros)."""
    A = st.FlatSymmetricTensor._raw(1, 4, jnp.arange(1, 5, dtype=jnp.int32))
    out = symalg.multiply.outer(A, A)
    dense = np.multiply.outer(np.arange(1, 5), np.arange(1, 5))
    np.testing.assert_allclose(np.asarray(out.todense()), dense, atol=1e-6)


def test_basis_change_donate_root(rng, monkeypatch):
    """donate_root frees the undivided root buffer after the gather split
    (the rank-6 bf16 flagship needs the 3.2 GB back) without changing
    the result."""
    from symtensor_tpu.ops.basis_change import basis_change_packed

    # force the root split at toy size (generic path: split pieces
    # replace the root; root-kernel path: freed after the last window)
    monkeypatch.setenv("SYMTENSOR_GATHER_MAX_BYTES", "512")
    dense = random_sym(4, 6, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense))
    W = jnp.asarray(rng.normal(size=(6, 6)))
    want = basis_change_packed(A, W)
    for root_env in ("0", "1"):
        monkeypatch.setenv("SYMTENSOR_BASIS_ROOT", root_env)
        A2 = st.FlatSymmetricTensor._raw(4, 6, A.data + 0)
        got = basis_change_packed(A2, W, donate_root=True)
        np.testing.assert_allclose(
            np.asarray(got.data), np.asarray(want.data), atol=1e-9
        )
        with pytest.raises(RuntimeError):
            np.asarray(A2.data[:1])


@pytest.mark.parametrize(
    "ra,rb,k,dim",
    [(3, 3, 1, 8), (3, 4, 2, 7), (4, 4, 3, 6), (2, 5, 2, 6), (3, 3, 3, 7)],
)
def test_tensordot_paired_route(ra, rb, k, dim, rng):
    """The pair-contraction route (G = F_A·diag(γ)·F_Bᵀ, then n_sub
    gathers of G per output) must agree with the table/stream routes and
    the dense oracle — including k ≥ 2 (host-expanded F positions) and
    full contraction of one operand (ka = 0)."""
    from symtensor_tpu.ops import outer as ou

    assert ou._paired_feasible(ra, rb, k, dim)
    da, db = random_sym(ra, dim, rng), random_sym(rb, dim, rng)
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(da))
    B = st.FlatSymmetricTensor.from_dense(jnp.asarray(db))
    got = symalg.tensordot(A, B, axes=k)  # default routing → paired
    want = symalg.tensordot(A, B, axes=k, stream=True)
    oracle = sym_np(np.tensordot(da, db, axes=k))
    r_out = ra + rb - 2 * k
    g = float(got.todense()) if r_out == 0 else np.asarray(got.todense())
    w = float(want.todense()) if r_out == 0 else np.asarray(want.todense())
    np.testing.assert_allclose(g, oracle, atol=1e-8)
    np.testing.assert_allclose(g, w, atol=1e-8)
