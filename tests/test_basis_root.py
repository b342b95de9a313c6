"""Exactness of the case-decomposed root-pass kernel (ops/basis_root.py).

The kernel decomposes the t = 0 basis-change gather by the gflat insert
cases (i ≥ g merged A+B+C bundle contraction; i < g case-D transposed
gather) — these tests prove it against the direct insert-position oracle
and against the generic step path, over ranks 4-6 and rectangular W.

Reference semantics: symalg.contract_all_indices_with_matrix
(/root/reference/symtensor/symalg.py:475-496).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import symtensor_tpu as st
from symtensor_tpu.ops import basis_root as br
from symtensor_tpu.ops.basis_change import basis_change_packed
from symtensor_tpu.utils import combinatorics as comb


@pytest.mark.parametrize(
    "k,d", [(3, 4), (3, 7), (4, 5), (4, 8), (5, 6), (6, 5)]
)
def test_root_kernel_vs_oracle(k, d):
    rng = np.random.default_rng(k * 31 + d)
    A = rng.normal(size=(comb.indep_size(k + 1, d),))
    d_out = d + 2
    W = rng.normal(size=(d, d_out))
    npar, b_lo = 3, 2
    Wp = np.concatenate([W, np.zeros((d, 8))], axis=1)
    kern = br.root_pass_kernel(k, d, npar, "float64", "float64")
    IH, J = br.root_tables_jnp(k, d)
    Bs = tuple(br.split_root_groups(jnp.asarray(A), k, d))
    got = np.asarray(
        kern(Bs, jnp.asarray(Wp), jnp.int32(b_lo), IH, J)
    ).reshape(npar, -1)
    want = br.root_pass_oracle(A, W, k, d, b_lo, npar)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_root_kernel_tiling_invariance():
    """Tail-triangle tiling must not change results."""
    k, d, npar = 4, 7, 4
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.normal(size=(comb.indep_size(k + 1, d),)))
    Wp = jnp.asarray(rng.normal(size=(d, npar + 4)))
    IH, J = br.root_tables_jnp(k, d)
    big = br.root_pass_kernel(k, d, npar, "float64", "float64")
    small = br.root_pass_kernel(
        k, d, npar, "float64", "float64", tile_elems=64
    )
    Bs = tuple(br.split_root_groups(A, k, d))
    a = np.asarray(big(Bs, Wp, jnp.int32(0), IH, J))
    b = np.asarray(small(Bs, Wp, jnp.int32(0), IH, J))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("r,d,d_out", [(4, 6, 6), (5, 5, 7), (4, 9, 5)])
def test_basis_change_root_path_matches_generic(r, d, d_out):
    """basis_change_packed with the root kernel ≡ the generic step path."""
    rng = np.random.default_rng(r + d)
    n = comb.indep_size(r, d)
    A = st.FlatSymmetricTensor._raw(
        r, d, jnp.asarray(rng.normal(size=(n,)))
    )
    W = jnp.asarray(rng.normal(size=(d, d_out)))
    old_env = os.environ.get("SYMTENSOR_BASIS_ROOT")
    try:
        os.environ["SYMTENSOR_BASIS_ROOT"] = "0"
        C_old = basis_change_packed(
            A, W, block_elems=5000, transient_elems=4096
        )
        os.environ["SYMTENSOR_BASIS_ROOT"] = "1"
        C_new = basis_change_packed(
            A, W, block_elems=5000, transient_elems=4096
        )
    finally:
        if old_env is None:
            os.environ.pop("SYMTENSOR_BASIS_ROOT", None)
        else:
            os.environ["SYMTENSOR_BASIS_ROOT"] = old_env
    np.testing.assert_allclose(
        np.asarray(C_old.data), np.asarray(C_new.data), rtol=0, atol=1e-11
    )


def test_root_kernel_chunked_matches_monolithic():
    """g-chunked programs assembled piecewise ≡ the single-program kernel
    (the chunking exists because the monolithic d-group program SIGKILLed
    the AOT compile helper at the rank-6 flagship)."""
    k, d, npar = 4, 8, 3
    rng = np.random.default_rng(5)
    A = jnp.asarray(rng.normal(size=(comb.indep_size(k + 1, d),)))
    Wp = jnp.asarray(rng.normal(size=(d, npar + 4)))
    IH, J = br.root_tables_jnp(k, d)
    mono = br.root_pass_kernel(k, d, npar, "float64", "float64")
    Bs = br.split_root_groups(A, k, d)
    want = np.asarray(mono(tuple(Bs), Wp, jnp.int32(1), IH, J))
    chunks = br.g_chunks(d, 10)
    assert len(chunks) > 2
    assert [c0 for c0, _ in chunks][0] == 0 and chunks[-1][1] == d
    n_k = comb.indep_size(k, d)
    buf = jnp.zeros((npar * n_k,), jnp.float64)
    col = 0
    for c0, c1 in chunks:
        kern = br.root_pass_kernel(
            k, d, npar, "float64", "float64", g0=c0, g1=c1
        )
        piece = kern(tuple(Bs[c0:]), Wp, jnp.int32(1), IH, J)
        nc = br.chunk_cols(k, d, c0, c1)
        assert piece.size == npar * nc
        buf = br.root_dus(npar, n_k, nc, "float64")(buf, piece, col)
        col += nc
    assert col == n_k
    np.testing.assert_allclose(np.asarray(buf), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("r,d,d_out", [(4, 7, 6), (5, 5, 6)])
def test_basis_change_chunked_root_matches_generic(r, d, d_out, monkeypatch):
    """Full basis change with a tiny per-program slice budget (forcing
    many root chunks) ≡ the generic step path."""
    rng = np.random.default_rng(2 * r + d)
    n = comb.indep_size(r, d)
    A = st.FlatSymmetricTensor._raw(
        r, d, jnp.asarray(rng.normal(size=(n,)))
    )
    W = jnp.asarray(rng.normal(size=(d, d_out)))
    monkeypatch.setenv("SYMTENSOR_BASIS_ROOT", "0")
    C_old = basis_change_packed(A, W, block_elems=5000, transient_elems=4096)
    monkeypatch.setenv("SYMTENSOR_BASIS_ROOT", "1")
    monkeypatch.setenv("SYMTENSOR_BASIS_ROOT_SLICES", "9")
    C_new = basis_change_packed(A, W, block_elems=5000, transient_elems=4096)
    np.testing.assert_allclose(
        np.asarray(C_old.data), np.asarray(C_new.data), rtol=0, atol=1e-11
    )


def test_root_kernel_bf16_one_pass_close():
    """bf16 storage routes the products through one-pass bf16 operands
    (f32 accumulation) instead of the 6-pass f32-HIGHEST decomposition —
    results must agree with the f64 oracle at bf16 noise level."""
    k, d, npar, b_lo = 4, 7, 3, 1
    rng = np.random.default_rng(11)
    A = rng.normal(size=(comb.indep_size(k + 1, d),))
    W = rng.normal(size=(d, d + 1))
    Wp = np.concatenate([W, np.zeros((d, 8))], axis=1)
    kern = br.root_pass_kernel(k, d, npar, "bfloat16", "float32")
    IH, J = br.root_tables_jnp(k, d)
    Bs = tuple(
        br.split_root_groups(jnp.asarray(A, jnp.bfloat16), k, d)
    )
    got = np.asarray(
        kern(Bs, jnp.asarray(Wp, jnp.float32), jnp.int32(b_lo), IH, J)
        .astype(jnp.float32)
    ).reshape(npar, -1)
    want = br.root_pass_oracle(A, W, k, d, b_lo, npar)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2 * scale)


def test_basis_change_bf16_blocked_close():
    """Full blocked basis change with bf16 storage (the flagship config:
    bf16 blocks, one-pass bf16 products, f32 accumulation) tracks the f64
    result at bf16 noise level."""
    r, d, d_out = 5, 5, 6
    rng = np.random.default_rng(3)
    n = comb.indep_size(r, d)
    vals = rng.normal(size=(n,))
    W = rng.normal(size=(d, d_out))
    A64 = st.FlatSymmetricTensor._raw(r, d, jnp.asarray(vals))
    C64 = basis_change_packed(
        A64, jnp.asarray(W), block_elems=5000, transient_elems=4096
    )
    A16 = st.FlatSymmetricTensor._raw(
        r, d, jnp.asarray(vals, jnp.bfloat16)
    )
    C16 = basis_change_packed(
        A16,
        jnp.asarray(W, jnp.float32),
        block_elems=5000,
        transient_elems=4096,
        store_dtype=jnp.bfloat16,
    )
    got = np.asarray(C16.data.astype(jnp.float32))
    want = np.asarray(C64.data)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-2 * scale)
