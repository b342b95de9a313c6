"""Domain contractions — the reference's headline ops (symalg.py:475-642).

- ``contract_all_indices_with_vector``: full polynomial evaluation
  Σ A_{i1..ir} x_{i1}…x_{ir}. On packed storage this is computed as
  r!·⟨vals, W⟩ where W is the EGF-weighted monomial vector
  ∏_v x_v^{c_v}/c_v! built by a static gather recursion — one O(n) pass,
  never materializing d^r (the reference's generic path densifies r times,
  symalg.py:526).
- Scalar-compressed σ-classes are evaluated in O(r·d) via monomial symmetric
  polynomials (power-sum recursion) — tensors like rank-6 dim-200 with
  structured classes evaluate without touching an O(n) array at all.
- ``contract_all_indices_with_matrix``: basis change C = A·W⊗…⊗W via a
  Schatz-style sequence of single-index contractions on mixed-symmetry
  packed intermediates (the reference only has densify+einsum,
  symalg.py:475-496; the compressed algorithm sketch lives in its graveyard,
  module_purgatory/torch_symmetric_tensor.py:487-534).
- ``contract_tensor_list``: quasi-symmetric contraction against a list of
  symmetric tensors (symalg.py:555-642).
"""

from __future__ import annotations

import math
import os
from collections import Counter
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..core.base import SymmetricTensor
from ..core.dense import DenseSymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..core.permcls import PermClsSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import value_prec
from ..utils.tables import _check_table, tables
from . import outer as outer_mod

# ---------------------------------------------------------------------------
# Monomial symmetric polynomials via power sums (scalar-class fast path)
# ---------------------------------------------------------------------------


def power_sums(x: jnp.ndarray, kmax: int) -> dict:
    x = jnp.asarray(x)
    p = {}
    xk = x
    for k in range(1, kmax + 1):
        p[k] = xk.sum()
        if k < kmax:
            xk = xk * x
    return p


def monomial_symmetric(counts, x) -> jnp.ndarray:
    """m_λ(x) = Σ over index classes in σ-class λ of ∏ x^λ — evaluated in
    O(r·d + #partitions) from power sums via the augmented-monomial
    recursion  m̃_{λ∪μ} = m̃_λ p_μ − Σ_t m̃_{λ with λ_t+μ}."""
    lam = tuple(sorted(comb.as_class_counts(counts), reverse=True))
    r = sum(lam)
    if r == 0:
        return jnp.asarray(1.0, dtype=jnp.asarray(x).dtype)
    p = power_sums(x, r)
    memo = {}

    def aug(t):
        if not t:
            return 1.0
        if t in memo:
            return memo[t]
        rest, last = t[:-1], t[-1]
        val = aug(rest) * p[last]
        for i in range(len(rest)):
            merged = tuple(
                sorted(rest[:i] + (rest[i] + last,) + rest[i + 1 :],
                       reverse=True)
            )
            val = val - aug(merged)
        memo[t] = val
        return val

    denom = 1
    for m in Counter(lam).values():
        denom *= math.factorial(m)
    return aug(lam) / denom


# ---------------------------------------------------------------------------
# contract_all_indices_with_vector
# ---------------------------------------------------------------------------


def _egf_weights(t, x: jnp.ndarray, rank: int) -> jnp.ndarray:
    """W[m] = ∏_v x_v^{c_v}/c_v! over all rank-`rank` multisets, storage
    order... in *colex* order (identical to gflat order only for the levels
    used internally; final level is colex — see note in caller)."""
    w = jnp.ones((1,), dtype=x.dtype)
    for par, mx, run in t.mono_tables_weighted(rank):
        w = w[par] * x[mx] / run.astype(x.dtype)
    return w


def _contract_vec_flat_simple(A: FlatSymmetricTensor, x) -> jnp.ndarray:
    """Reference-grade EGF path: builds the full weighted monomial vector
    (O(n) extra tables/intermediates). Kept as a cross-check oracle for the
    grouped kernel; production dispatch uses kernels.poly_eval."""
    x = jnp.asarray(x)
    r = A.rank
    if r == 0:
        return A.data[0]
    if r == 1:
        return jnp.dot(A.data, x.astype(A.dtype), precision=value_prec(A.dtype))
    t = A.tables
    w = _egf_weights(t, x, r)
    # The EGF recursion enumerates multisets in colex order; reorder to the
    # gflat storage order through the static permutation.
    w = w[t.colex_perm]
    return float(math.factorial(r)) * jnp.dot(
        A.data, w.astype(A.data.dtype), precision=value_prec(A.data.dtype)
    )


def _contract_vec_flat(A: FlatSymmetricTensor, x) -> jnp.ndarray:
    x = jnp.asarray(x)
    if A.rank > 0 and x.shape != (A.dim,):
        raise ValueError(
            f"vector length {x.shape} must match dim {A.dim} "
            "(reference symalg.py:517)"
        )
    # Concrete tensors: cached premul views + ONE jitted evaluation — the
    # headline path (bench.py). The eager per-group path would dispatch
    # ~6 small programs per group, each compiled on first use. Traced
    # tensors (this op under the caller's jit over A): views can't be
    # cached on tracers, so keep the barrier-copy path. Opt-out (e.g. to avoid the one-off
    # full-size premul view copy on memory-tight devices):
    # SYMTENSOR_EVAL_FAST=0.
    from ..kernels.poly_eval import poly_eval_flat, poly_eval_flat_fast

    if (
        isinstance(A.data, jax.core.Tracer)
        or os.environ.get("SYMTENSOR_EVAL_FAST", "1") == "0"
    ):
        return poly_eval_flat(A, x)
    return poly_eval_flat_fast(A, x)


def _contract_vec_permcls(A: PermClsSymmetricTensor, x) -> jnp.ndarray:
    """Per-σ-class evaluation:

    - scalar-compressed classes: γ_σ·c·m_λ(x) via power sums — O(r·d)
      regardless of class size (the rank-6 dim-200 BASELINE config);
    - vector classes: γ_σ·⟨leaf, ∏_k x[rep_σ[:,k]]⟩ through a per-class
      representative-index table (s_σ·r entries, cached); falls back to the
      packed grouped kernel if the tables would exceed the size guard.
    """
    x = jnp.asarray(x)
    total = jnp.zeros((), dtype=jnp.result_type(A.dtype, x.dtype))
    vector_part = {}
    for cnts, leaf in A.data.items():
        if leaf.ndim == 0:
            gamma = comb.class_multiplicity(cnts) if A.rank else 1
            total = total + leaf * gamma * monomial_symmetric(cnts, x)
        else:
            vector_part[cnts] = leaf
    if not vector_part:
        return total
    t = A.tables
    try:
        # Accumulate separately: if any class_rep exceeds the table guard we
        # must fall back for ALL vector classes (adding a partial sum first
        # would double-count the classes already processed).
        vec_total = jnp.zeros((), dtype=total.dtype)
        for cnts, leaf in vector_part.items():
            rep_c = t.class_rep(cnts)  # (s_σ, r) int32 device
            mono = x[rep_c[:, 0]]
            for k in range(1, A.rank):
                mono = mono * x[rep_c[:, k]]
            gamma = comb.class_multiplicity(cnts)
            vec_total = vec_total + gamma * jnp.dot(
                leaf.astype(total.dtype),
                mono.astype(total.dtype),
                precision=value_prec(total.dtype),
            )
        return total + vec_total
    except MemoryError:
        pass
    # tables too large → zero the scalar classes and go through packed
    store = {
        k: (v if v.ndim else jnp.zeros((), dtype=A.dtype))
        for k, v in A.data.items()
    }
    B = PermClsSymmetricTensor._raw(A.rank, A.dim, store)
    return total + _contract_vec_flat(B.toflat(), x)


def contract_all_indices_with_vector(symtensor, x) -> jnp.ndarray:
    """Σ_{i1…ir} A_{i1…ir} x_{i1}…x_{ir} (reference symalg.py:505-527).

    Returns a 0-d jax array (design delta: the reference returns a rank-0
    SymmetricTensor or Python scalar)."""
    A = symtensor
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    if A.format in ("decomp", "sparse_flat"):
        return A.contract_all_indices_with_vector(x)
    if A.format == "permcls":
        return _contract_vec_permcls(A, x)
    if A.format == "dense":
        x = jnp.asarray(x, dtype=A.dtype)
        out = A.data
        for _ in range(A.rank):
            out = jnp.dot(out, x, precision=value_prec(A.dtype))
        return out
    return _contract_vec_flat(A.toflat(), x)


def contract_all_indices_with_vector_batched(symtensor, xs) -> jnp.ndarray:
    """Batched polynomial evaluation: xs (B, dim) → (B,).

    Format-specialized: packed tensors use the grouped GEMM kernel
    (matrix-unit work at large B); decomp uses one batched einsum; other formats vmap
    the single-input path. This is the BASELINE 'jit+vmap over 1024 inputs'
    configuration as a first-class op.
    """
    A = symtensor
    xs = jnp.asarray(xs)
    if xs.ndim != 2:
        raise ValueError(f"xs must be (batch, dim); got {xs.shape}")
    if A.rank > 0 and xs.shape[1] != A.dim:
        raise ValueError(
            f"xs second axis {xs.shape[1]} must equal dim {A.dim}"
        )
    if A.format == "flat":
        # Concrete tensors: cached-views grouped GEMMs (routing in the
        # poly_eval_flat_batched_fast docstring). Traced tensors (this op
        # under the caller's jit): the barrier-copy path — views can't be
        # cached on tracers.
        from ..kernels.poly_eval import (
            poly_eval_flat_batched,
            poly_eval_flat_batched_fast,
        )

        if isinstance(A.data, jax.core.Tracer):
            return poly_eval_flat_batched(A, xs)
        return poly_eval_flat_batched_fast(A, xs)
    if A.format == "decomp":
        import string

        v = jnp.dot(
            A.factors, xs.T.astype(A.dtype),
            precision=value_prec(A.dtype),
        )  # (F, B)
        k = A.num_indep_factors
        if k == 0:
            return jnp.broadcast_to(A.weights.reshape(()), (xs.shape[0],))
        letters = string.ascii_lowercase[:k]
        spec = (
            letters
            + ","
            + ",".join(f"{c}B" for c in letters)
            + "->B"
        )
        return jnp.einsum(
            spec,
            A.weights,
            *[v**m for m in A.multiplicities],
            precision=value_prec(A.dtype),
        )
    return jax.vmap(lambda x: contract_all_indices_with_vector(A, x))(xs)


# ---------------------------------------------------------------------------
# contract_all_indices_with_matrix (basis change)
# ---------------------------------------------------------------------------


def _basis_change_flat(A: FlatSymmetricTensor, W: jnp.ndarray, **kw):
    """Blocked Schatz-style basis change — see ops/basis_change.py."""
    from .basis_change import basis_change_packed

    return basis_change_packed(A, W, **kw)


def contract_all_indices_with_matrix(symtensor, W, **kw):
    """C_{j1…jr} = Σ_{i1…ir} A_{i1…ir} W_{i1 j1} … W_{ir jr}
    (reference symalg.py:475-496). Rectangular W changes the dimension.
    The result of contracting every index of a symmetric tensor is itself
    symmetric, so no explicit symmetrization is needed.

    Packed formats run the blocked output-major recursion
    (ops/basis_change.py): bounded memory at any size, ~rank compiled
    programs. Keyword options (block_elems, transient_elems, store_dtype,
    acc_dtype) tune residency for very large tensors."""
    A = symtensor
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    if A.format == "decomp":
        return A.contract_all_indices_with_matrix(W)
    if A.format == "dense":
        W = jnp.asarray(W, dtype=A.dtype)
        out = A.data
        for _ in range(A.rank):
            # contract leading original axis, append new axis at the end
            out = jnp.tensordot(
                out, W, axes=[[0], [0]], precision=value_prec(A.dtype)
            )
        return DenseSymmetricTensor._raw(
            A.rank, W.shape[1] if A.rank else A.dim, out
        )
    flat = _basis_change_flat(A.toflat(), W, **kw)
    if A.format == "permcls":
        return flat.topermcls()
    return flat


# ---------------------------------------------------------------------------
# contract_tensor_list
# ---------------------------------------------------------------------------


def _stack_flat(tensor_list) -> jnp.ndarray:
    flats = [χ.toflat().data for χ in tensor_list]
    return jnp.stack(flats)  # (d, n_m)


def _combine_bilinear(T: jnp.ndarray, ra: int, rb: int, dim: int):
    """out_K = (1/C(r,ra)) Σ_S T[posA(K_S), posB(K_∖S)] for a joint matrix
    T of shape (n_ra, n_rb) — the generalized symmetric outer."""
    ta, tb = outer_mod._subset_tables(ra, rb, dim)
    n_sub = ta.shape[0]
    acc = None
    for s in range(n_sub):
        term = T[ta[s], tb[s]]
        acc = term if acc is None else acc + term
    r = ra + rb
    if r == 0:
        return FlatSymmetricTensor._raw(0, 1, (acc / n_sub).reshape(1))
    return FlatSymmetricTensor._raw(r, dim, acc / n_sub)


def contract_tensor_list(
    symtensor,
    tensor_list: Sequence[SymmetricTensor],
    n_times: int = 1,
    rule: str = "all",
):
    """B = Symmetrize[ Σ_{i1…in} A[i1,…,in, …] ⊗ χ_{i1} ⊗ … ⊗ χ_{in} ]
    (reference symalg.py:555-642). `tensor_list` emulates the first index of
    a quasi-symmetric χ; result rank = (r − n) + n·m.

    Design delta: the default rule is 'all'. The reference defaults to
    'second_half' (contract only indices ≥ ⌈d/2⌉, symalg.py:560), which its
    own tests always override; pass rule='second_half' for that behavior.
    """
    A = symtensor
    if not isinstance(A, SymmetricTensor):
        raise TypeError("first operand must be a SymmetricTensor")
    tensor_list = list(tensor_list)
    if n_times > A.rank:
        raise ValueError(
            f"n_times={n_times} exceeds tensor rank {A.rank}"
        )
    if len(tensor_list) != A.dim:
        raise ValueError(
            f"tensor_list length {len(tensor_list)} must equal dim {A.dim}"
        )
    ranks = {χ.rank for χ in tensor_list}
    dims = {χ.dim for χ in tensor_list}
    if len(ranks) > 1 or len(dims) > 1:
        raise ValueError("tensor_list entries must all have the same shape")
    m = ranks.pop()
    dχ = dims.pop()
    if dχ != A.dim:
        raise ValueError("tensor_list entries must match symtensor's dim")

    d = A.dim
    if rule == "second_half":
        values = list(range(math.ceil(d / 2), d))
    elif rule == "all":
        values = list(range(d))
    else:
        raise ValueError(f"unknown rule {rule!r}")

    Af = A.toflat()

    # rank-1 fast path: B = Σ_i A_i χ_i (reference symalg.py:627)
    if A.rank == 1 and n_times == 1:
        X = _stack_flat(tensor_list)  # (d, n_m)
        coeff = Af.data
        if rule == "second_half":
            mask = jnp.zeros((d,), dtype=coeff.dtype).at[jnp.asarray(values)].set(1)
            coeff = coeff * mask
        return FlatSymmetricTensor._raw(
            m, d,
            jnp.dot(coeff, X.astype(coeff.dtype),
                    precision=value_prec(coeff.dtype)),
        )

    if n_times == 1:
        # T[I, J] = Σ_i A[sort(I∪i)] χ_i[J]  — one matmul, then the
        # subset combine (fully vectorized).
        X = _stack_flat(tensor_list).astype(Af.dtype)  # (d, n_m)
        tbl = Af.tables.insert_table(A.rank - 1)  # (N_{r-1}, d)
        MA = Af.data[tbl]  # (N_{r-1}, d)
        if rule == "second_half":
            mask = jnp.zeros((d,), dtype=MA.dtype).at[jnp.asarray(values)].set(1)
            MA = MA * mask[None, :]
        T = jnp.dot(MA, X, precision=value_prec(MA.dtype))  # (N_{r-1}, n_m)
        return _combine_bilinear(T, A.rank - 1, m, d)

    # general n ≥ 2: peel one contraction index and recurse —
    # B = Σ_i sym( contract_tensor_list(A[i,…], χ, n−1) ⊗ χ_i )
    # (nested symmetrizations collapse into the outer one, so summing over
    # ordered i with the vectorized inner path is exact).
    #
    # n == 2 is vectorized with vmap over i: the whole level is ONE
    # compiled program (d separate recursions were compile-dominated at
    # the C4 bench size).
    t_in = Af.tables
    if n_times == 2:
        ins = t_in.insert_table(A.rank - 1)  # (N_{r-1}, d)
        A_parts = Af.data[ins.T]  # (d, N_{r-1}) — all partials at once
        X = _stack_flat(tensor_list).astype(Af.dtype)  # (d, n_m)
        idx = jnp.asarray(values, dtype=jnp.int32)

        def peel(data_i, chi_i):
            Ai = FlatSymmetricTensor._raw(A.rank - 1, d, data_i)
            Ci = contract_tensor_list(
                Ai, tensor_list, n_times=1, rule=rule
            )
            term = outer_mod.symmetric_outer(
                Ci.toflat(), FlatSymmetricTensor._raw(m, d, chi_i)
            )
            return term.toflat().data

        terms = jax.vmap(peel)(A_parts[idx], X[idx])  # (|values|, n_out)
        out_rank = (A.rank - 2) + 2 * m
        return FlatSymmetricTensor._raw(out_rank, d, terms.sum(axis=0))

    # n ≥ 3: same peel, but the level runs as ONE compiled lax.scan over
    # the contraction index with an in-place accumulator — the recursion
    # inside the body is the (vectorized) n−1 path, so the whole call
    # compiles ~n programs total instead of d^(n−2) Python recursions
    # (the C4 config otherwise compiles d separate subtrees on first
    # call).  The accumulator keeps peak memory at one
    # output vector instead of a (d, n_out) stack.
    ins = t_in.insert_table(A.rank - 1)  # (N_{r-1}, d)
    A_parts = Af.data[ins.T]  # (d, N_{r-1})
    X = _stack_flat(tensor_list).astype(Af.dtype)  # (d, n_m)
    idx = jnp.asarray(values, dtype=jnp.int32)
    out_rank = (A.rank - n_times) + n_times * m
    n_out = comb.indep_size(out_rank, d)

    def body(acc, xs):
        data_i, chi_i = xs
        Ai = FlatSymmetricTensor._raw(A.rank - 1, d, data_i)
        Ci = contract_tensor_list(
            Ai, tensor_list, n_times=n_times - 1, rule=rule
        )
        term = outer_mod.symmetric_outer(
            Ci.toflat(), FlatSymmetricTensor._raw(m, d, chi_i)
        )
        return acc + term.toflat().data.astype(acc.dtype), None

    init = jnp.zeros((n_out,), dtype=Af.dtype)
    total, _ = jax.lax.scan(body, init, (A_parts[idx], X[idx]))
    return FlatSymmetricTensor._raw(out_rank, d, total)
