"""Cell-major prefix-GEMM batched polynomial evaluation.

Reparametrizes each packed component by its two LARGEST indices (the
"cell" (t1, t2)) and the r-2 smallest (a colex monomial g with
max(g) <= t1):

    I = (g_1 .. g_{r-2}, t1, t2)     ascending
    W_I = M2[g] * x_{t1} * x_{t2} * s(g, t1, t2)

where M2 is the level-(r-2) EGF-weighted monomial vector (the grouped
kernel's head recursion taken two levels deeper) and the collision factor

    s = 1/(a+1)            for t1 < t2
    s = 1/((a+1)(a+2))     for t1 == t2,     a = multiplicity of t1 in g

is *batch-independent*, so it premultiplies into the stored values.
Colex enumeration makes {g : max(g) <= t1} a PREFIX of size N(t1+1), so
evaluating a block of rows ra <= t1 < rb is ONE big-K GEMM

    G = M2[:, :N(rb)] @ V_block      # (B, K) @ (K, NC) -> (B, NC)

against a host-prepared matrix of premultiplied values (zeroed where
max(g) > t1), followed by the tiny epilogue  sum_cells x_{t1} x_{t2} G.

Contrast with the grouped batched path (poly_eval.py), which materializes
a (B, sum_j T_j) triangle intermediate — ~(d+2)/3-fold redundant (34x at
d = 100) and memory-bound.  Here device-memory traffic is one pass over the
values plus O(B * sum_b K_b) prefix reads (tens of MB at C5), and every
GEMM has K in the hundreds-to-thousands — proper matrix-unit shapes
instead of skinny T_j-contractions.

Reference semantics: contract_all_indices_with_vector
(/root/reference/symtensor/symalg.py:505-527); the implicit-symmetrization
summand identity is the same EGF weighting used in kernels/poly_eval.py.
"""

from __future__ import annotations

import math
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.tables import tables as get_tables

# Eligibility: the level-(r-2) monomial table must stay modest, both for
# the (B, N2) batched weight build and the host-side index tables.
_MAX_LEVEL2 = 65536
# Chunk the batch so the (B_c, N2) weight table stays under ~128 MB f32.
_MAX_WEIGHT_ELEMS = 1 << 25


def cell_eligible(rank: int, dim: int) -> bool:
    return rank >= 3 and comb.multiset_count(dim, rank - 2) <= _MAX_LEVEL2


@lru_cache(maxsize=None)
def _cell_blocks_static(rank: int, dim: int):
    """Host-side static data: row blocks of the cell-major layout.

    Returns a tuple of blocks, each
        (K, t1s, t2s, idx, scale)
    with K = N(rb) the prefix length, t1s/t2s (NC,) the block's cells,
    idx (K*NC,) int32 gather positions into the gflat packed layout, and
    scale (K*NC,) float64 premultiplied collision factors (0 where
    max(g) > t1; cast to the storage dtype at view build).
    """
    r, d = rank, dim
    if r < 3:
        raise ValueError("cell-major layout needs rank >= 3")
    lay = comb.gflat_layout(r, d)
    gs = comb.multisets_colex(d, r - 2)  # (N2, r-2) ascending rows, colex
    N2 = gs.shape[0]
    gmax = gs[:, -1]
    grun = (gs == gmax[:, None]).sum(axis=1)  # run of the max element
    Npref = np.array(
        [comb.multiset_count(m, r - 2) for m in range(d + 1)], np.int64
    )

    # Greedy row blocks: grow while the triangular zero-padding stays a
    # small fraction of the useful entries (bounds both wasted GEMM FLOPs
    # and the extra device copy).
    bounds = []
    ra = 0
    while ra < d:
        rb = ra + 1
        useful = int((d - ra) * Npref[ra + 1])
        waste = 0
        while rb < d:
            add_useful = int((d - rb) * Npref[rb + 1])
            # growing the block to include row rb raises K to N(rb+1):
            new_K = int(Npref[rb + 1])
            new_waste = 0
            for t1 in range(ra, rb + 1):
                new_waste += (new_K - int(Npref[t1 + 1])) * (d - t1)
            if new_waste > 0.12 * (useful + add_useful) + 4096:
                break
            rb += 1
            useful += add_useful
            waste = new_waste
        bounds.append((ra, rb))
        ra = rb

    blocks = []
    total_valid = 0
    for ra, rb in bounds:
        K = int(Npref[rb])
        t1s_list, t2s_list = [], []
        for t1 in range(ra, rb):
            for t2 in range(t1, d):
                t1s_list.append(t1)
                t2s_list.append(t2)
        t1s = np.asarray(t1s_list, np.int32)
        t2s = np.asarray(t2s_list, np.int32)
        NC = t1s.shape[0]
        # (K, NC) validity: g (colex rank < N(t1+1)) may pair with cell
        g_rank = np.arange(K, dtype=np.int64)
        valid = g_rank[:, None] < Npref[t1s + 1][None, :]
        # collision factor: a = count of t1 in g (nonzero iff max(g)==t1)
        a = np.where(
            gmax[:K, None] == t1s[None, :].astype(np.int64),
            grun[:K, None],
            0,
        ).astype(np.float64)
        scale = 1.0 / (a + 1.0)
        diag = (t1s == t2s)[None, :]
        scale = np.where(diag, scale / (a + 2.0), scale)
        scale = np.where(valid, scale, 0.0)  # float64; cast at view build
        # gather positions: I = (g..., t1, t2); replace invalid g by the
        # all-zeros monomial so rows stay ascending (scale is 0 anyway)
        g_safe = np.where(valid[:, :, None], gs[:K, None, :], 0)
        rows = np.empty((K, NC, r), np.int64)
        rows[:, :, : r - 2] = g_safe
        rows[:, :, r - 2] = t1s[None, :]
        rows[:, :, r - 1] = t2s[None, :]
        pos = lay.position_array(rows.reshape(K * NC, r))
        blocks.append(
            (
                K,
                t1s,
                t2s,
                pos.astype(np.int32),
                scale.reshape(-1),
            )
        )
        total_valid += int(valid.sum())
    assert total_valid == lay.n, (rank, dim, total_valid, lay.n)
    return tuple(blocks)


def cell_views(A: FlatSymmetricTensor):
    """Device-resident premultiplied value blocks for A: per block a
    (K, NC) matrix in A's storage dtype, plus the cell index vectors.

    Built once per tensor and cached on the instance (tensors are
    immutable) — except under an active trace, where the gathers inline
    into the surrounding jit and nothing is cached (caching tracers would
    leak them)."""
    tracing = isinstance(A.data, jax.core.Tracer)
    if not tracing:
        cached = getattr(A, "_cell_views", None)
        if cached is not None:
            return cached
    r, d = A.rank, A.dim
    static = _cell_blocks_static(r, d)

    def prep(vals):
        out = []
        for K, t1s, t2s, idx, scale in static:
            NC = t1s.shape[0]
            # (NC, K): cells on the leading axis — the GEMM contracts K
            # against the (K, B) transposed weight table, and every gather
            # in the eval is a leading-axis (row) gather of whole rows.
            V = (
                vals[jnp.asarray(idx)]
                * jnp.asarray(scale).astype(vals.dtype)
            ).reshape(K, NC).T
            out.append(V)
        return tuple(out)

    Vs = prep(A.data) if tracing else jax.jit(prep)(A.data)
    views = tuple(
        (V, jnp.asarray(t1s), jnp.asarray(t2s))
        for V, (K, t1s, t2s, idx, scale) in zip(Vs, static)
    )
    if not tracing:
        try:
            object.__setattr__(A, "_cell_views", views)
        except Exception:  # noqa: BLE001 — caching is best-effort
            pass
    return views


def _level_weights_batched_T(t, xsT, size: int, ct):
    """(N_size, B) EGF-weighted monomials, batch on the LANE axis.

    The recursion's par/mx indexing lands on the leading axis (row
    gathers of whole rows; the (B, N) orientation would gather single
    elements along the minor axis)."""
    B = xsT.shape[1]
    if size == 0:
        return jnp.ones((1, B), dtype=ct)
    M = jnp.ones((1, B), dtype=ct)
    for par, mx, run in t.mono_tables_weighted(size):
        M = M[par] * xsT[mx] / run[:, None].astype(ct)
    return M


@lru_cache(maxsize=None)
def _cell_eval_jitted(rank: int, dim: int):
    def f(views, xs):
        t = get_tables(rank, dim)
        ct = jnp.result_type(views[0][0].dtype, xs.dtype)
        xsT = xs.astype(ct).T  # (d, B)
        M2T = _level_weights_batched_T(t, xsT, rank - 2, ct)  # (N2, B)
        B = xsT.shape[1]
        # precision follows jax_default_matmul_precision: the default may
        # run f32 operands at reduced precision (TF32 on the GPU); users
        # needing full f32 set the global precision flag
        prec = None
        total = jnp.zeros((B,), dtype=ct)
        for V, t1s, t2s in views:  # V: (NC, K)
            K = V.shape[1]
            G = jax.lax.dot_general(
                V,
                M2T[:K].astype(V.dtype),
                (((1,), (0,)), ((), ())),
                preferred_element_type=ct,
                precision=prec,
            )  # (NC, B)
            xp = xsT[t1s] * xsT[t2s]  # row gathers → (NC, B)
            total = total + jnp.einsum("cb,cb->b", G.astype(ct), xp)
        return float(math.factorial(rank)) * total

    return jax.jit(f)


def poly_eval_cell_batched(A: FlatSymmetricTensor, xs) -> jnp.ndarray:
    """Batched contraction xs (B, d) -> (B,) via the cell-major GEMMs.

    Eager entry point; caches the premultiplied value blocks on A and the
    jitted evaluator per (rank, dim). Chunks the batch so the (B, N2)
    weight table stays bounded. Caller must check `cell_eligible`.
    """
    xs = jnp.asarray(xs)
    views = cell_views(A)
    f = _cell_eval_jitted(A.rank, A.dim)
    B = xs.shape[0]
    N2 = comb.multiset_count(A.dim, A.rank - 2)
    chunk = max(16, _MAX_WEIGHT_ELEMS // max(N2, 1))
    if B <= chunk:
        return f(views, xs)
    parts = [f(views, xs[i : i + chunk]) for i in range(0, B, chunk)]
    return jnp.concatenate(parts)
