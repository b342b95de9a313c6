"""Case-decomposed root pass for the blocked basis change.

The t = 0 step of `basis_change_packed` computes, for each output index
b in a window and every size-k child multiset j,

    U1[b, j] = Σ_i A[pos(sort(j ∪ {i}))] · W[i, b]

with positions in the parent (rank k+1) gflat layout.  The generic step
kernel services this with a 1-D element gather (the parent block has one
row) — 9.2e9 incidences per window at rank-6 dim-100, the dominant cost
of the whole flagship basis change on the previous accelerator
(docs/design_slab_gather.md).

This module replaces the root pass with the gflat case decomposition
(same case analysis as utils/slabs.py, verified in tests/test_slabs.py),
reformulated so every read is either a contiguous slice or the 2-D
axis-1 shared-index gather (one index vector amortized over all rows):

With child j = [head (size kh = k−3) | g | ta, tb] and insert value i:

- **i ≥ g** (cases A+B+C of the design doc, merged): the parent is
  [head, g | sorted(ta, tb, i)] — its head' = [head, g] is FIXED.  The
  parent rows with head' = [head, g] across parent groups G ≥ g form a
  contiguous "row bundle" per head (parent rows hpb_g + h of every
  group-G block, hpb_g = C(g+kh, kh+1)), and

      out[h, (ta, tb)] += Σ_{i ≥ g} Bundle[h, τ3(ta, tb, i)] · W[i, b]

  where τ3 is the bundle-local rank of the sorted triple — a gather
  whose index depends only on ((ta, tb), i), SHARED across heads: the
  fast axis-1 form on the (nh_g, L_g) bundle matrix.  The bundle is
  built from (d − g) contiguous slices of A (parent rows are stored
  consecutively per group).

- **i < g** (case D): the parent is [sort(head ∪ {i}) | g | ta, tb] —
  the tail triangle rides along unchanged.  On the TRANSPOSED parent
  group-g block (T_g, nhp_g), the read is an axis-1 gather with the
  head-level insert table IH[h, i] = colex(sort(head_h ∪ {i})), again
  shared across the T_g tail rows.

Both gathers are driven by two tiny global int32 tables (≈2 MB each at
d = 100) sliced per g; the whole window is ONE jitted program with a
host-unrolled loop over the d child groups (static shapes per g — no
lax.map, no large device tables).

The parent arrives as PER-GROUP 2-D blocks (nhp_G, T_G), split once by
`split_root_groups`, NOT as one flat (N_{k+1},) array: XLA's layout
assignment can react to many `reshape(slice(param), (nh, T_G))`
consumers by retiling the whole 1-D parameter to (N/10, 10), which a
tiled device layout pads many times over (seen as a compile-time OOM at
the rank-6 dim-100 flagship on the previous accelerator;
optimization_barrier does not help).  With 2-D block params every
access is a natural row slice or transpose.  The split itself avoids
the pattern too: one program of plain 1-D slices, then one program
reshaping each piece param to 2-D.

Reference semantics: symalg.contract_all_indices_with_matrix
(/root/reference/symtensor/symalg.py:475-496); the reference has no
compressed-domain analog (it densifies to d^r).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import combinatorics as comb
from .basis_change import _dot_operand_dtype


@lru_cache(maxsize=None)
def _tri_table(d: int) -> np.ndarray:
    """(T_0, 2) int64 of the (a ≤ b) pairs of tri(d) in row-major order."""
    rows = []
    for a in range(d):
        blk = np.empty((d - a, 2), dtype=np.int64)
        blk[:, 0] = a
        blk[:, 1] = np.arange(a, d)
        rows.append(blk)
    return np.concatenate(rows, axis=0)


@lru_cache(maxsize=None)
def bundle_table(d: int) -> np.ndarray:
    """J[(a,b)-tri-rank, i] = bundle offset (from group 0) of the parent
    element holding sorted(a, b, i):  S[x] + tri_rank(y−x, z−x, d−x)
    for (x, y, z) = sorted(a, b, i), S[x] = Σ_{G<x} T_G.

    The per-g table is the contiguous sub-block J[T_0−T_g:, g:] − S[g]
    (child tails with min ≥ g are the last T_g tri rows; inserts i ≥ g
    are a column suffix).  int32: max value S[d] ≤ C(d+2, 3) < 2^31 for
    any practical d."""
    T = ((d - np.arange(d)) * (d - np.arange(d) + 1) // 2).astype(np.int64)
    S = np.concatenate(([0], np.cumsum(T)))
    tri = _tri_table(d)  # (T0, 2)
    a = tri[:, 0][:, None]  # (T0, 1)
    b = tri[:, 1][:, None]
    i = np.arange(d, dtype=np.int64)[None, :]  # (1, d)
    x = np.minimum(np.minimum(a, b), i)
    z = np.maximum(np.maximum(a, b), i)
    y = a + b + i - x - z
    J = S[x] + comb.tri_rank(y - x, z - x, d - x)
    return J.astype(np.int32)


@lru_cache(maxsize=None)
def head_insert_table(kh: int, d: int) -> np.ndarray:
    """IH[h, i] = colex rank of sort(head_h ∪ {i}) over size-(kh+1)
    multisets, for head_h the h-th size-kh multiset in colex order.

    The per-g slice is the contiguous prefix IH[:nh_g, :g] (heads ≤ g
    are a colex prefix of length C(g+kh, kh)).  (1, d) for kh = 0."""
    heads = comb.multisets_colex(d, kh)  # (Nh, kh) ascending
    Nh = heads.shape[0]
    ins = np.empty((Nh, d, kh + 1), dtype=np.int64)
    ins[:, :, :kh] = heads[:, None, :]
    ins[:, :, kh] = np.arange(d)[None, :]
    ins.sort(axis=2)
    flat = ins.reshape(Nh * d, kh + 1)
    ranks = comb.colex_rank_array(flat).reshape(Nh, d)
    return ranks.astype(np.int32)


def _plan(k: int, d: int):
    """Static host-side schedule shared by the kernel and the oracle."""
    if k < 3:
        raise ValueError("root-pass case kernel requires child rank ≥ 3")
    kh = k - 3
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    T = lay_c.T.astype(np.int64)  # same for parent/child
    S = np.concatenate(([0], np.cumsum(T)))
    return kh, lay_c, lay_p, T, S


def g_chunks(d: int, budget: int):
    """Contiguous child-group ranges with Σ_{g∈range}(d−g) ≤ budget.

    Each range compiles as its own jitted program: the bundle build for
    group g emits (d−g) slice ops, and the monolithic d-group program at
    the rank-6 flagship was SIGKILLed inside the AOT compile helper
    (compile memory/time scales with program op count).  ~9 programs at
    d = 100 with the default budget."""
    chunks = []
    g0, acc = 0, 0
    for g in range(d):
        c = d - g
        if acc and acc + c > budget:
            chunks.append((g0, g))
            g0, acc = g, 0
        acc += c
    chunks.append((g0, d))
    return chunks


def group_shapes(k: int, d: int):
    """(nhp_G, T_G) of the parent (rank k+1) gflat group blocks."""
    kh = k - 3
    T = ((d - np.arange(d)) * (d - np.arange(d) + 1) // 2).astype(np.int64)
    return [
        (int(comb.multiset_count(G + 1, kh + 1)), int(T[G]))
        for G in range(d)
    ]


@lru_cache(maxsize=None)
def _slice_groups_kernel(k: int, d: int, dt: str):
    """One program: flat parent → tuple of 1-D group pieces (plain slices
    only — reshaping them HERE would re-trigger the layout retile)."""
    _, _, lay_p, T_arr, _ = _plan(k, d)
    shapes = group_shapes(k, d)

    def kern(A):
        out = []
        for G in range(d):
            nhp, T = shapes[G]
            off = int(lay_p.group_off[G])
            out.append(jax.lax.slice(A, (off,), (off + nhp * T,)))
        return tuple(out)

    return jax.jit(kern)


@lru_cache(maxsize=None)
def _reshape_groups_kernel(k: int, d: int, dt: str):
    """One program: tuple of 1-D group pieces → tuple of 2-D (nhp, T)
    blocks (reshape-of-param is layout-safe; inputs are donated)."""
    shapes = group_shapes(k, d)

    def kern(*pieces):
        return tuple(
            p.reshape(shapes[G]) for G, p in enumerate(pieces)
        )

    return jax.jit(kern, donate_argnums=tuple(range(d)))


def split_root_groups(A_flat, k: int, d: int):
    """Split the flat parent level into per-group 2-D device blocks.

    Costs one extra copy of the parent (two programs, the first's outputs
    donated to the second); the caller may delete `A_flat` afterwards —
    the blocks are independent buffers."""
    dt = str(A_flat.dtype)
    pieces = _slice_groups_kernel(k, d, dt)(A_flat)
    return list(_reshape_groups_kernel(k, d, dt)(*pieces))


def chunk_cols(k: int, d: int, g0: int, g1: int) -> int:
    """Child columns produced by groups [g0, g1): Σ nh_g·T_g."""
    kh = k - 3
    tot = 0
    for g in range(g0, g1):
        tot += int(comb.multiset_count(g + 1, kh)) * int(
            comb.tri_size(d - g)
        )
    return tot


@lru_cache(maxsize=None)
def root_dus(npar: int, n_k: int, cols: int, store_dt: str):
    """Donated DUS of a (npar, cols) piece into the (npar, n_k) child
    view at a traced column offset — assembles chunked root-pass pieces
    without a multi-GB concat transient."""
    store = jnp.dtype(store_dt)

    @partial(jax.jit, donate_argnums=(0,))
    def put(buf, piece, c0):
        b2 = buf.reshape(npar, n_k)
        p2 = piece.reshape(npar, cols).astype(store)
        out = jax.lax.dynamic_update_slice(
            b2, p2, (jnp.int32(0), jnp.asarray(c0, jnp.int32))
        )
        return out.reshape(-1)

    return put


@lru_cache(maxsize=None)
def root_pass_kernel(k: int, d: int, npar: int, store_dt: str, acc_dt: str,
                     tile_elems: int = 200_000_000,
                     g0: int = 0, g1: int | None = None):
    """Jitted (Bs, W_padded, b_lo, IH, J) → child flat (npar·cols,)
    for child groups g ∈ [g0, g1) (full child when g0 = 0, g1 = None).

    Bs: tuple of the parent's 2-D group blocks for groups [g0, d)
    (from `split_root_groups`, sliced `blocks[g0:]` by the caller);
    W_padded: (d, ≥ b_lo+npar) — b_lo is traced, everything else
    static.  Output is npar-major, the layout
    `basis_change._step_kernel` expects of a parent block.
    `tile_elems` bounds the (nh, T, n) gather transient per g by tiling
    the tail-triangle axis."""
    kh, lay_c, lay_p, T_arr, S = _plan(k, d)
    store = jnp.dtype(store_dt)
    acc = jnp.dtype(acc_dt)
    T0 = int(comb.tri_size(d))
    if g1 is None:
        g1 = d
    # When the blocks are ALREADY bf16, feeding them to the dot as bf16
    # (f32 accumulation via preferred_element_type) loses nothing — the
    # data carries bf16 noise either way, and W's bf16 rounding (~2^-9
    # relative) is below it — while f32 + HIGHEST would multiply the
    # work.  f32 storage keeps f32 + HIGHEST.  See _dot_operand_dtype for
    # the CPU exception.
    mxu = _dot_operand_dtype(store, acc)
    prec = None if mxu == jnp.bfloat16 else jax.lax.Precision.HIGHEST

    def kern(Bs, Wp, b_lo, IH, J):
        b_lo = jnp.asarray(b_lo, jnp.int32)
        Wc = jax.lax.dynamic_slice(
            Wp, (jnp.int32(0), b_lo), (d, npar)
        ).astype(mxu)  # (d, npar)
        pieces = []
        for g in range(g0, g1):
            n = d - g
            T = int(T_arr[g])
            nh = int(comb.multiset_count(g + 1, kh))
            hpb = comb.binom(g + kh, kh + 1)
            # ---- cases A+B+C: inserts i ≥ g ----
            # row bundle: rows [hpb, hpb+nh) of every group-G block,
            # G ≥ g — plain 2-D row slices of the block params
            parts = []
            for G in range(g, d):
                TG = int(T_arr[G])
                parts.append(
                    jax.lax.slice(Bs[G - g0], (hpb, 0), (hpb + nh, TG))
                )
            P = jnp.concatenate(parts, axis=1)  # (nh, L_g)
            Jg = (
                jax.lax.slice(J, (T0 - T, g), (T0, d)) - np.int32(S[g])
            )  # (T, n)
            # ---- case D: inserts i < g (transposed group-g block) ----
            if g > 0:
                Pg = Bs[g - g0].T  # (T, nhp)
                IHg = jax.lax.slice(IH, (0, 0), (nh, g))  # (nh, g)
            # tile the tail-triangle axis so the (nh, t, n) transient
            # stays bounded (≈340 MB f32 untiled at the rank-6 midpoint)
            rows_per = max(1, min(T, tile_elems // max(1, nh * n)))
            out_tiles = []
            for t0 in range(0, T, rows_per):
                t1 = min(t0 + rows_per, T)
                tl = t1 - t0
                G2 = (
                    P[:, Jg[t0:t1].reshape(-1)]
                    .reshape(nh, tl, n)
                    .astype(mxu)
                )
                o = jax.lax.dot_general(
                    G2, Wc[g:],
                    (((2,), (0,)), ((), ())),
                    preferred_element_type=acc,
                    # f32 storage asks for HIGHEST so no faster algorithm
                    # rounds its operands; bf16 storage runs as bf16
                    precision=prec,
                )  # (nh, tl, npar)
                if g > 0:
                    G1 = (
                        Pg[t0:t1, IHg.reshape(-1)]
                        .reshape(tl, nh, g)
                        .astype(mxu)
                    )
                    oD = jax.lax.dot_general(
                        G1, Wc[:g],
                        (((2,), (0,)), ((), ())),
                        preferred_element_type=acc,
                        precision=prec,
                    )  # (tl, nh, npar)
                    o = o + jnp.transpose(oD, (1, 0, 2))
                out_tiles.append(o)
            out_g = (
                out_tiles[0] if len(out_tiles) == 1
                else jnp.concatenate(out_tiles, axis=1)
            )  # (nh, T, npar)
            pieces.append(
                jnp.transpose(out_g, (2, 0, 1)).reshape(npar, nh * T)
            )
        # (npar, Σ_{g∈[g0,g1)} nh_g·T_g) — the full (npar, N_k) child
        # when the range covers all d groups
        child = jnp.concatenate(pieces, axis=1).astype(store)
        return child.reshape(-1)

    return jax.jit(kern)


def root_pass_oracle(A_np: np.ndarray, W_np: np.ndarray, k: int, d: int,
                     b_lo: int, npar: int) -> np.ndarray:
    """Direct numpy evaluation of the root step (insert positions via the
    layout's position_array) — the exactness oracle for the case kernel."""
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    reps = lay_c.rep_indices()  # (N_k, k)
    n_k = reps.shape[0]
    out = np.zeros((npar, n_k), dtype=np.float64)
    for i in range(d):
        ins = np.empty((n_k, k + 1), dtype=np.int64)
        ins[:, :k] = reps
        ins[:, k] = i
        ins.sort(axis=1)
        pos = lay_p.position_array(ins)
        vals = A_np[pos]
        for bb in range(npar):
            out[bb] += vals * W_np[i, b_lo + bb]
    return out


def root_tables_jnp(k: int, d: int):
    """Device copies of the two global gather tables for `root_pass_kernel`
    (uploaded once per (k, d): ≈4 MB at the rank-6 flagship)."""
    return (
        jnp.asarray(head_insert_table(k - 3, d)),
        jnp.asarray(bundle_table(d)),
    )
