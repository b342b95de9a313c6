"""Grouped-GEMV polynomial evaluation — the benchmark kernel.

Computes  Σ_{i1…ir} A_{i1…ir} x_{i1}…x_{ir} = r!·Σ_I vals_I·W_I  with
W_I = ∏_v x_v^{c_v}/c_v! (EGF weights), exploiting the gflat layout:

every component is (head ≤ j, j, tail-pair ≥ j), so the sum factorizes into
d *static-shape* GEMVs — one per group j — against contiguous slices of a
global triangle-monomial vector, plus tiny per-head corrections for value
collisions at j:

    result = r!·Σ_j Σ_h M̃_h · [ c1(q) · ⟨V_h, TRI_j⟩
                               + c2(q) · ⟨V_h[:d−j], TRI_row_j⟩
                               + c3(q) · V_h[0]·TRI_cell_j ]

where M̃ are EGF head monomials (size C(d+r−4, r−3) — e.g. 176 851 at
rank 6 dim 100 vs 1.6e9 components), q is the head's trailing count of j,
and c1,c2,c3 absorb the (q+1)(q+2)(q+3) factorial corrections for tails
touching j. Device-memory traffic ≈ one pass over the values — the
speed-of-light for this memory-bound op (every value is used exactly once).
The jnp formulation is compiled by XLA; there is no hand-written kernel.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import value_prec


@lru_cache(maxsize=None)
def _grouped_static(rank: int, dim: int):
    """Static per-(rank,dim) data for the grouped evaluation."""
    lay = comb.gflat_layout(rank, dim)
    P = [int(v) for v in lay.P]
    T = [int(v) for v in lay.T]
    goff = [int(v) for v in lay.group_off]
    toff = [int(v) for v in lay.tri_off]
    return P, T, goff, toff


def _head_weights(t, x: jnp.ndarray, rank: int):
    """EGF head monomials M̃ (colex, size N_{r-3}) plus static (maxel,
    maxrun) arrays used to derive each head's trailing-j run length."""
    hsize = rank - 3
    if hsize == 0:
        one = jnp.ones((1,), dtype=x.dtype)
        return one, jnp.full((1,), -1, jnp.int32), jnp.zeros((1,), jnp.int32)
    levels = t.mono_tables_weighted(hsize)
    w = jnp.ones((1,), dtype=x.dtype)
    for par, mx, run in levels:
        w = w[par] * x[mx] / run.astype(x.dtype)
    par, mx, run = levels[-1]
    return w, mx, run.astype(jnp.int32)


# Groups whose tail width is below this are stored transposed (T_j, P_j),
# so the long head axis is the minor (contiguous) one: a (P_j, T_j) matrix
# with a short minor axis reads poorly on a tiled memory layout.  Chosen on
# the previous accelerator; not yet re-decided for the GPU.
_TRANSPOSE_BELOW = 128


def _is_transposed(Pj: int, Tj: int) -> bool:
    return Tj < _TRANSPOSE_BELOW <= Pj


def group_views(A: FlatSymmetricTensor):
    """Per-group matrices of the packed values: (P_j, T_j), or (T_j, P_j)
    transposed for narrow tail groups (see _TRANSPOSE_BELOW).

    Built once per tensor (cached on the instance — tensors are immutable)
    with a jitted slice/reshape prep. Evaluation over views needs no
    optimization_barrier copies: each GEMV reads a cleanly-laid-out matrix.
    Costs one extra copy of the values in device memory.
    """
    cached = getattr(A, "_group_views", None)
    if cached is not None:
        return cached
    r, d = A.rank, A.dim
    P, T, goff, _ = _grouped_static(r, d)

    @jax.jit
    def prep(vals):
        out = []
        for j in range(d):
            chunk = jax.lax.slice(
                vals, (goff[j],), (goff[j] + P[j] * T[j],)
            )
            chunk = jax.lax.optimization_barrier(chunk)
            V = chunk.reshape(P[j], T[j])
            out.append(V.T if _is_transposed(P[j], T[j]) else V)
        return tuple(out)

    views = prep(A.data)
    try:
        object.__setattr__(A, "_group_views", views)
    except Exception:  # noqa: BLE001 — caching is best-effort
        pass
    return views


def poly_eval_flat(A: FlatSymmetricTensor, x) -> jnp.ndarray:
    """Single-input full contraction on packed storage."""
    r, d = A.rank, A.dim
    x = jnp.asarray(x)
    vals = A.data
    ct = jnp.result_type(vals.dtype, x.dtype)
    x = x.astype(ct)
    if r == 0:
        return vals[0].astype(ct)
    if r == 1:
        return jnp.dot(vals.astype(ct), x, precision=value_prec(ct))

    t = A.tables
    ta, tb = t.tri_pairs
    tri = x[ta] * x[tb]
    # halve the diagonal cells (u == w → x_u²/2!)
    diag = (ta == tb).astype(ct)
    tri = tri * (1.0 - 0.5 * diag)

    if r == 2:
        return 2.0 * jnp.dot(vals.astype(ct), tri, precision=value_prec(ct))

    M, maxel, maxrun = _head_weights(t, x, r)
    get_V = _barrier_view_getter(vals, r, d)
    return _eval_core(get_V, tri, x, M, maxel, maxrun, r, d, ct)


def _barrier_view_getter(vals, r, d):
    P, T, goff, _ = _grouped_static(r, d)

    def get_V(j, ct):
        Pj, Tj = P[j], T[j]
        chunk = jax.lax.slice(vals, (goff[j],), (goff[j] + Pj * Tj,))
        # Barrier: without it XLA rewrites reshape(slice(vals)) into
        # slice(reshape(vals)) whenever goff % T == 0, materializing the
        # full value array as (n/T, T) — which a tiled device layout pads
        # many times over at rank-6 dim-100.
        chunk = jax.lax.optimization_barrier(chunk)
        return chunk.reshape(Pj, Tj)

    return get_V


def _dot1(mat, vec, contract_axis, ct):
    """mat·vec contracting one axis, accumulating in ct without upcasting
    the (possibly bf16) matrix in memory. Precision follows value_prec:
    under vmap these become GEMMs, where DEFAULT precision may run f32
    operands at reduced precision (TF32 on the GPU's tensor cores)."""
    return jax.lax.dot_general(
        mat,
        vec.astype(mat.dtype),
        (((contract_axis,), (0,)), ((), ())),
        preferred_element_type=ct,
        precision=value_prec(mat.dtype),
    )


def _eval_core(get_V, tri, x, M, maxel, maxrun, r, d, ct):
    P, T, goff, toff = _grouped_static(r, d)
    total = jnp.zeros((), dtype=ct)
    for j in range(d):
        Tj = T[j]
        V = get_V(j, ct)
        tri_j = jax.lax.slice(tri, (toff[j],), (toff[j] + Tj,))
        row_len = d - j
        if V.shape == (Tj, P[j]) and Tj != P[j]:
            # transposed narrow-tail view: contract the leading axis
            u_full = _dot1(V, tri_j, 0, ct)
            u_row = _dot1(V[:row_len], tri_j[:row_len], 0, ct)
            u_cell = V[0].astype(ct) * tri_j[0]
        else:
            u_full = _dot1(V, tri_j, 1, ct)
            u_row = _dot1(V[:, :row_len], tri_j[:row_len], 1, ct)
            u_cell = V[:, 0].astype(ct) * tri_j[0]
        Pj = P[j]
        q = jnp.where(maxel[:Pj] == j, maxrun[:Pj], 0).astype(ct)
        c1 = x[j] / (q + 1)
        c2 = c1 * (1.0 / (q + 2) - 1.0)
        c3 = c1 * (2.0 / ((q + 2) * (q + 3)) - 1.0 / (q + 2))
        total = total + jnp.dot(
            M[:Pj], c1 * u_full + c2 * u_row + c3 * u_cell,
            precision=value_prec(ct),
        )
    return float(math.factorial(r)) * total


@lru_cache(maxsize=None)
def _premul_static(rank: int, dim: int):
    """Static per-group correction ratios for premultiplied views.

    The per-group correction sum M·(c1·u_full + c2·u_row + c3·u_cell)
    factors as M·c1·(u_full + ρ2·u_row + ρ3·u_cell) with x-INDEPENDENT
    ratios ρ2 = c2/c1 = 1/(q+2) − 1 and ρ3 = c3/c1 (q = trailing run of j
    in the head), so ρ2/ρ3 premultiply into the stored values — the
    u_row/u_cell GEMVs disappear, along with their re-reads of the values
    (the strided V[:, 0] cell column reads whole memory tiles).

    Returns per-group (rho2, rho3) float64 arrays of length P_j."""
    hsize = rank - 3
    if hsize == 0:
        heads_max = np.full(1, -1, np.int64)
        runs = np.zeros(1, np.int64)
    else:
        heads = comb.multisets_colex(dim, hsize)
        heads_max = heads[:, -1]
        runs = (heads == heads_max[:, None]).sum(axis=1)
    P, T, goff, toff = _grouped_static(rank, dim)
    out = []
    for j in range(dim):
        Pj = P[j]
        q = np.where(heads_max[:Pj] == j, runs[:Pj], 0).astype(np.float64)
        rho2 = 1.0 / (q + 2.0) - 1.0
        rho3 = 2.0 / ((q + 2.0) * (q + 3.0)) - 1.0 / (q + 2.0)
        out.append((rho2, rho3))  # float64; cast to storage dtype at build
    return tuple(out)


def group_views_premul(A: FlatSymmetricTensor):
    """Per-group value matrices with the ρ2/ρ3 correction zones folded in:
    evaluation needs ONE GEMV per group (vs full+row+cell). Cached on the
    tensor like group_views; same orientation rules."""
    cached = getattr(A, "_group_views_premul", None)
    if cached is not None:
        return cached
    r, d = A.rank, A.dim
    P, T, goff, _ = _grouped_static(r, d)
    ratios = _premul_static(r, d)

    @jax.jit
    def prep(vals):
        out = []
        for j in range(d):
            Pj, Tj = P[j], T[j]
            chunk = jax.lax.slice(
                vals, (goff[j],), (goff[j] + Pj * Tj,)
            )
            chunk = jax.lax.optimization_barrier(chunk)
            V = chunk.reshape(Pj, Tj)
            rho2, rho3 = ratios[j]
            r2 = jnp.asarray(rho2).astype(vals.dtype)
            r3 = jnp.asarray(rho3).astype(vals.dtype)
            rl = d - j
            parts = [V[:, :1] * (1.0 + r2 + r3)[:, None]]
            if rl > 1:
                parts.append(V[:, 1:rl] * (1.0 + r2)[:, None])
            if Tj > rl:
                parts.append(V[:, rl:])
            Vp = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
            out.append(Vp.T if _is_transposed(Pj, Tj) else Vp)
        return tuple(out)

    views = prep(A.data)
    try:
        object.__setattr__(A, "_group_views_premul", views)
    except Exception:  # noqa: BLE001 — caching is best-effort
        pass
    return views


@lru_cache(maxsize=None)
def _views_eval_premul_jitted(rank: int, dim: int):
    """Single-input evaluation over premultiplied views: per group one
    GEMV + one weighted dot (no row/cell correction passes)."""
    from ..utils.tables import tables as get_tables

    def f(views, x):
        t = get_tables(rank, dim)
        x = jnp.asarray(x)
        ct = jnp.result_type(views[0].dtype, x.dtype)
        x = x.astype(ct)
        ta, tb = t.tri_pairs
        tri = x[ta] * x[tb]
        tri = tri * (1.0 - 0.5 * (ta == tb).astype(ct))
        M, maxel, maxrun = _head_weights(t, x, rank)
        P, T, goff, toff = _grouped_static(rank, dim)
        total = jnp.zeros((), dtype=ct)
        for j in range(dim):
            Pj, Tj = P[j], T[j]
            V = views[j]
            tri_j = jax.lax.slice(tri, (toff[j],), (toff[j] + Tj,))
            if V.shape == (Tj, Pj) and Tj != Pj:
                u = _dot1(V, tri_j, 0, ct)
            else:
                u = _dot1(V, tri_j, 1, ct)
            q = jnp.where(maxel[:Pj] == j, maxrun[:Pj], 0).astype(ct)
            total = total + jnp.dot(
                M[:Pj] * (x[j] / (q + 1.0)), u, precision=value_prec(ct)
            )
        return float(math.factorial(rank)) * total

    return jax.jit(f)


@lru_cache(maxsize=None)
def _views_eval_batched_premul_jitted(rank: int, dim: int):
    """Batched evaluation over premultiplied views (one GEMM per group)."""
    from ..utils.tables import tables as get_tables

    def f(views, xs):
        t = get_tables(rank, dim)
        xs = jnp.asarray(xs)
        ct = jnp.result_type(views[0].dtype, xs.dtype)
        xs = xs.astype(ct)
        ta, tb = t.tri_pairs
        tri = xs[:, ta] * xs[:, tb]
        tri = tri * (1.0 - 0.5 * (ta == tb).astype(ct))[None, :]
        M, maxel, maxrun = _batched_head_weights(t, xs, rank, ct)
        P, T, goff, toff = _grouped_static(rank, dim)
        B = xs.shape[0]
        total = jnp.zeros((B,), dtype=ct)
        for j in range(dim):
            Pj, Tj = P[j], T[j]
            V = views[j]
            tri_j = jax.lax.slice(tri, (0, toff[j]), (B, toff[j] + Tj))
            ax = 0 if (V.shape == (Tj, Pj) and Tj != Pj) else 1
            u = jax.lax.dot_general(
                tri_j.astype(V.dtype),
                V,
                (((1,), (ax,)), ((), ())),
                preferred_element_type=ct,
                precision=value_prec(V.dtype),
            )  # (B, Pj)
            q = jnp.where(maxel[:Pj] == j, maxrun[:Pj], 0).astype(ct)
            w = M[:, :Pj] * (xs[:, j : j + 1] / (q + 1.0)[None, :])
            total = total + jnp.einsum(
                "bp,bp->b", w, u, precision=value_prec(ct)
            )
        return float(math.factorial(rank)) * total

    return jax.jit(f)


@lru_cache(maxsize=None)
def _views_eval_jitted(rank: int, dim: int):
    """Cached jitted evaluator over pre-split group views — the fastest
    single-chip path (no per-call copies, clean 2-D layouts)."""
    from ..utils.tables import tables as get_tables

    def f(views, x):
        t = get_tables(rank, dim)
        x = jnp.asarray(x)
        ct = jnp.result_type(views[0].dtype, x.dtype)
        x = x.astype(ct)
        ta, tb = t.tri_pairs
        tri = x[ta] * x[tb]
        tri = tri * (1.0 - 0.5 * (ta == tb).astype(ct))
        M, maxel, maxrun = _head_weights(t, x, rank)
        return _eval_core(
            lambda j, c: views[j], tri, x, M, maxel, maxrun,
            rank, dim, ct,
        )

    return jax.jit(f)


def poly_eval_flat_fast(A: FlatSymmetricTensor, x) -> jnp.ndarray:
    """Eager entry point for repeated evaluation of one tensor: splits the
    packed values into cached per-group views once, then runs a cached
    jitted evaluation over them. Use inside jit → poly_eval_flat instead."""
    r = A.rank
    if r < 3:
        return poly_eval_flat(A, x)
    views = group_views_premul(A)
    return _views_eval_premul_jitted(r, A.dim)(views, x)


def poly_eval_flat_batched(A: FlatSymmetricTensor, xs) -> jnp.ndarray:
    """Batched contraction: xs (B, d) → (B,). The per-group GEMVs become
    GEMMs (P_j, T_j) @ (T_j, B) — matrix-unit work at large B."""
    r, d = A.rank, A.dim
    xs = jnp.asarray(xs)
    vals = A.data
    ct = jnp.result_type(vals.dtype, xs.dtype)
    xs = xs.astype(ct)
    B = xs.shape[0]
    if r == 0:
        return jnp.broadcast_to(vals[0].astype(ct), (B,))
    if r == 1:
        return jnp.dot(xs, vals.astype(ct), precision=value_prec(ct))

    t = A.tables
    ta, tb = t.tri_pairs
    tri = xs[:, ta] * xs[:, tb]  # (B, Ttri)
    diag = (ta == tb).astype(ct)
    tri = tri * (1.0 - 0.5 * diag)[None, :]

    if r == 2:
        return 2.0 * jnp.dot(
            tri, vals.astype(ct), precision=value_prec(ct)
        )

    M, maxel, maxrun = _batched_head_weights(t, xs, r, ct)
    get_V = _barrier_view_getter(vals, r, d)
    return _eval_core_batched(get_V, tri, xs, M, maxel, maxrun, r, d, ct)


def _eval_core_batched(get_V, tri, xs, M, maxel, maxrun, r, d, ct):
    """Shared batched epilogue: per-group GEMMs, both view orientations."""
    P, T, goff, toff = _grouped_static(r, d)
    B = xs.shape[0]
    total = jnp.zeros((B,), dtype=ct)

    def dotB(mat, tri_blk, contract_axis):
        # (B, T) x mat → (B, P), accumulating in ct without upcasting mat
        return jax.lax.dot_general(
            tri_blk.astype(mat.dtype),
            mat,
            (((1,), (contract_axis,)), ((), ())),
            preferred_element_type=ct,
            precision=value_prec(mat.dtype),
        )

    for j in range(d):
        Pj, Tj = P[j], T[j]
        V = get_V(j, ct)
        tri_j = jax.lax.slice(tri, (0, toff[j]), (B, toff[j] + Tj))
        row_len = d - j
        if V.shape == (Tj, Pj) and Tj != Pj:
            u_full = dotB(V, tri_j, 0)
            u_row = dotB(V[:row_len], tri_j[:, :row_len], 0)
            u_cell = tri_j[:, :1] * V[None, 0, :].astype(ct)
        else:
            u_full = dotB(V, tri_j, 1)
            u_row = dotB(V[:, :row_len], tri_j[:, :row_len], 1)
            u_cell = tri_j[:, :1] * V[None, :, 0].astype(ct)
        q = jnp.where(maxel[:Pj] == j, maxrun[:Pj], 0).astype(ct)
        xj = xs[:, j : j + 1]
        c1 = xj / (q + 1)[None, :]
        c2 = c1 * (1.0 / (q + 2) - 1.0)[None, :]
        c3 = c1 * (2.0 / ((q + 2) * (q + 3)) - 1.0 / (q + 2))[None, :]
        total = total + jnp.einsum(
            "bp,bp->b", M[:, :Pj], c1 * u_full + c2 * u_row + c3 * u_cell,
            precision=value_prec(ct),
        )
    return float(math.factorial(r)) * total


def _batched_head_weights(t, xs, rank, ct):
    hsize = rank - 3
    B = xs.shape[0]
    if hsize == 0:
        return (
            jnp.ones((B, 1), dtype=ct),
            jnp.full((1,), -1, jnp.int32),
            jnp.zeros((1,), jnp.int32),
        )
    levels = t.mono_tables_weighted(hsize)
    M = jnp.ones((B, 1), dtype=ct)
    for par, mx, run in levels:
        M = M[:, par] * xs[:, mx] / run.astype(ct)
    _, maxel, maxrun = levels[-1]
    return M, maxel, maxrun.astype(jnp.int32)


@lru_cache(maxsize=None)
def _views_eval_batched_jitted(rank: int, dim: int):
    from ..utils.tables import tables as get_tables

    def f(views, xs):
        t = get_tables(rank, dim)
        xs = jnp.asarray(xs)
        ct = jnp.result_type(views[0].dtype, xs.dtype)
        xs = xs.astype(ct)
        ta, tb = t.tri_pairs
        tri = xs[:, ta] * xs[:, tb]
        tri = tri * (1.0 - 0.5 * (ta == tb).astype(ct))[None, :]
        M, maxel, maxrun = _batched_head_weights(t, xs, rank, ct)
        return _eval_core_batched(
            lambda j, c: views[j], tri, xs, M, maxel, maxrun, rank, dim, ct
        )

    return jax.jit(f)


def poly_eval_flat_batched_fast(A: FlatSymmetricTensor, xs) -> jnp.ndarray:
    """Eager batched entry point over cached per-group views.

    Routing (decided on the previous accelerator at rank-4 dim-100,
    B=1024; not yet re-measured on the GPU): premultiplied views for bf16
    storage, plain grouped views otherwise; the cell-major prefix-GEMM
    kernel is opt-in via SYMTENSOR_BATCHED_CELL=1.
    Use inside jit → poly_eval_flat_batched (no view caching on tracers).
    """
    if A.rank < 3:
        return poly_eval_flat_batched(A, xs)
    if os.environ.get("SYMTENSOR_BATCHED_CELL") == "1":
        from .cell_gemm import cell_eligible, poly_eval_cell_batched

        if cell_eligible(A.rank, A.dim):
            return poly_eval_cell_batched(A, xs)
    if jnp.dtype(A.dtype) == jnp.bfloat16 or (
        # reuse an existing premul view cache rather than building a
        # SECOND full-size view copy (plain + premul caches together
        # would triple residency on big tensors — an extra 6.4 GB at
        # flagship size)
        getattr(A, "_group_views_premul", None) is not None
        and getattr(A, "_group_views", None) is None
    ):
        views = group_views_premul(A)
        return _views_eval_batched_premul_jitted(A.rank, A.dim)(views, xs)
    views = group_views(A)
    return _views_eval_batched_jitted(A.rank, A.dim)(views, xs)
