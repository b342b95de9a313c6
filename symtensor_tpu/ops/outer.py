"""Symmetrized outer products and tensordot in the compressed domain.

The reference computes these by densifying and averaging r! transposes
(symalg.py:206-283,424-459) — its documented main inefficiency. Here we use
the *position-subset identity*: for symmetric A (rank ra) and B (rank rb),

    sym(A ⊗ B)[K] = (1/C(r, ra)) · Σ_{S ⊆ positions(K), |S|=ra} A[K_S]·B[K_∖S]

where K is a sorted output multiset. Each subset term appears with equal
weight because choosing positions of a sorted tuple enumerates the split
multisets with exactly the multinomial redundancy the symmetrization needs.
Cost: C(r, ra) fused gather-multiplies over packed storage — no d^r, no r!.

Symmetrized tensordot over k axes adds an inner sum over contraction
multisets C with multiplicity γ_C:

    sym(A ·_k B)[K] = (1/C(r_out, ra−k)) Σ_S Σ_C γ_C · A[sort(K_S ∪ C)] · B[sort(C ∪ K_∖S)]
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.base import SymmetricTensor
from ..core.dense import DenseSymmetricTensor
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import value_prec
from ..utils.tables import _check_table, _i32, tables


def _as_flat(x) -> Tuple[FlatSymmetricTensor, bool]:
    """Coerce operand to flat; returns (flat, was_dense)."""
    if isinstance(x, SymmetricTensor):
        return x.toflat(), x.format == "dense"
    arr = jnp.asarray(x)
    if arr.ndim == 0:
        return FlatSymmetricTensor._raw(0, 1, arr.reshape(1)), False
    if arr.ndim == 1:
        return FlatSymmetricTensor._raw(1, arr.shape[0], arr), False
    return FlatSymmetricTensor.from_dense(arr), True


def _wrap_result(flat: FlatSymmetricTensor, *operands):
    """Result format promotion: dense only if all symmetric operands were
    dense (reference result_array keeps the common class, base.py:1757)."""
    symops = [o for o in operands if isinstance(o, SymmetricTensor)]
    if symops and all(o.format == "dense" for o in symops):
        return DenseSymmetricTensor._raw(flat.rank, flat.dim, flat.todense())
    if symops and all(o.format == "permcls" for o in symops):
        return flat.topermcls()
    return flat


@lru_cache(maxsize=None)
def _subset_tables(ra: int, rb: int, dim: int):
    """For each of the C(ra+rb, ra) position subsets: packed positions of
    the A-part and B-part of every output multiset. Device int32 arrays of
    shape (n_subsets, n_out)."""
    r = ra + rb
    t_out = tables(r, dim)
    rep = t_out.rep_np()  # (n_out, r) ascending
    subsets = list(itertools.combinations(range(r), ra))
    _check_table(len(subsets) * t_out.n * 2, f"subset_tables({ra},{rb})")
    t_a, t_b = tables(ra, dim), tables(rb, dim)
    a_rows, b_rows = [], []
    for S in subsets:
        Sc = tuple(i for i in range(r) if i not in S)
        ia = rep[:, S]  # rows stay sorted: subsequence of sorted row
        ib = rep[:, Sc]
        a_rows.append(_position_rows(t_a, ia))
        b_rows.append(_position_rows(t_b, ib))
    return _i32(np.stack(a_rows)), _i32(np.stack(b_rows))


def _position_rows(t, rows: np.ndarray) -> np.ndarray:
    if t.rank == 0:
        return np.zeros(len(rows), dtype=np.int64)
    if t.rank == 1:
        return rows[:, 0]
    return t.layout.position_array(rows)


def symmetric_outer(a, b, fn: str = "multiply", stream: bool = None):
    """sym(fn.outer(a, b)) — fn ∈ {multiply, add, subtract} (the reference
    registers .outer for these three, symalg.py:294). `stream` forces
    (True) or forbids (False) the blocked streaming path; default: stream
    when the subset gather tables would exceed the table guard."""
    # Decomp × Decomp multiply.outer is exact and lazy in that format.
    if (
        fn == "multiply"
        and isinstance(a, SymmetricTensor)
        and isinstance(b, SymmetricTensor)
        and a.format == b.format == "decomp"
        and a.rank > 0
        and b.rank > 0
    ):
        return a.outer_decomp(b)

    af, a_dense = _as_flat(a)
    bf, b_dense = _as_flat(b)
    ra, rb = af.rank, bf.rank

    ops = {
        "multiply": jnp.multiply,
        "add": jnp.add,
        "subtract": jnp.subtract,
    }
    f = ops[fn]

    # Scalar operands short-circuit (reference outer handles scalars,
    # symalg.py:295-316). fn.outer with a scalar operand is elementwise
    # against the other operand, keeping argument order.
    if ra == 0 or rb == 0:
        if ra == 0 and rb == 0:
            out = FlatSymmetricTensor._raw(0, 1, f(af.data, bf.data))
        elif ra == 0:
            out = FlatSymmetricTensor._raw(
                bf.rank, bf.dim, f(af.data[0], bf.data)
            )
        else:
            out = FlatSymmetricTensor._raw(
                af.rank, af.dim, f(af.data, bf.data[0])
            )
        return _wrap_result(out, a, b)

    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim = af.dim
    r = ra + rb

    if stream is None:
        entries = 2 * comb.binom(r, ra) * comb.indep_size(r, dim)
        stream = entries > _table_guard_limit() or (
            # under a caller's jit, gather tables would be baked into the
            # traced program as constants (260 MB of MLIR at
            # rank-3×rank-3 dim-30); the streamed kernel ranks positions
            # in-kernel instead
            entries > _TRACED_TABLE_LIMIT
            and (
                isinstance(af.data, jax.core.Tracer)
                or isinstance(bf.data, jax.core.Tracer)
            )
        )
    if stream:
        if fn != "multiply":
            # add/subtract outers are affine in the operands; reuse the
            # multiplicative streaming kernel against an all-ones operand.
            ones_a = FlatSymmetricTensor._raw(
                ra, dim, jnp.ones_like(af.data)
            )
            ones_b = FlatSymmetricTensor._raw(
                rb, dim, jnp.ones_like(bf.data)
            )
            va = _combine_streamed(af, ones_b, 0)
            vb = _combine_streamed(ones_a, bf, 0)
            vals = va + vb if fn == "add" else va - vb
        else:
            vals = _combine_streamed(af, bf, 0)
        return _wrap_result(FlatSymmetricTensor._raw(r, dim, vals), a, b)

    ta, tb = _subset_tables(ra, rb, dim)
    n_sub = ta.shape[0]
    acc = None
    for s in range(n_sub):
        term = f(af.data[ta[s]], bf.data[tb[s]])
        acc = term if acc is None else acc + term
    out = FlatSymmetricTensor._raw(r, dim, acc / n_sub)
    return _wrap_result(out, a, b)


@lru_cache(maxsize=None)
def _tensordot_tables(ra: int, rb: int, k: int, dim: int):
    """Subset × contraction-multiset gather tables for symmetrized
    tensordot: positions into A of sort(K_S ∪ C) with shape
    (n_subsets, n_k, n_out), likewise for B, plus γ_C."""
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    rep = t_out.rep_np() if r_out > 0 else np.zeros((1, 0), dtype=np.int64)
    tk = tables(k, dim)
    creps = tk.rep_np()  # (n_k, k)
    n_k = len(creps)
    subsets = list(itertools.combinations(range(r_out), ka))
    _check_table(
        2 * len(subsets) * n_k * max(len(rep), 1),
        f"tensordot_tables({ra},{rb},{k})",
    )
    t_a, t_b = tables(ra, dim), tables(rb, dim)
    gam = comb.row_multiplicities(creps).astype(np.float64)
    A_tab = np.empty((len(subsets), n_k, len(rep)), dtype=np.int64)
    B_tab = np.empty_like(A_tab)
    for si, S in enumerate(subsets):
        Sc = tuple(i for i in range(r_out) if i not in S)
        ia = rep[:, S]  # (n_out, ka)
        ib = rep[:, Sc]
        for ci in range(n_k):
            c = creps[ci]
            full_a = np.sort(
                np.concatenate(
                    [ia, np.broadcast_to(c, (len(rep), k))], axis=1
                ),
                axis=1,
            )
            full_b = np.sort(
                np.concatenate(
                    [ib, np.broadcast_to(c, (len(rep), k))], axis=1
                ),
                axis=1,
            )
            A_tab[si, ci] = _position_rows(t_a, full_a)
            B_tab[si, ci] = _position_rows(t_b, full_b)
    with jax.ensure_compile_time_eval():  # memoized: never trace-bound
        gam_dev = jnp.asarray(gam.astype(np.float32))
    return (
        _i32(A_tab),
        _i32(B_tab),
        gam_dev,
        len(subsets),
    )


# ---------------------------------------------------------------------------
# Pair-contraction route: out[K] = (1/n_sub) Σ_S G[pos(K_S), pos(K_∖S)]
# with G = F_A · diag(γ) · F_Bᵀ and F_A[u, c] = A[sort(u ∪ c)].
#
# The contraction multiset sum collapses into ONE GEMM over the small
# expanded matrices (N_ka, N_k)·(N_k, N_kb), and the per-output work drops
# from 2·n_sub·n_k gathered elements to n_sub gathered elements of G —
# ~2·n_k fewer (200× at rank-3×rank-3 axes=1 dim-100, where the streaming
# path gathers 5.3e9 elements in 57 s).  Feasible whenever F_A, F_B, G and
# the output representative table fit the element gate below.
# ---------------------------------------------------------------------------


def _paired_limit() -> int:
    import os

    return int(os.environ.get("SYMTENSOR_TENSORDOT_PAIRED", 150_000_000))


@lru_cache(maxsize=None)
def _expand_positions(klvl: int, k: int, dim: int):
    """Device (N_klvl, N_k) int32: position in the rank-(klvl+k) layout of
    sort(u ∪ c) for u the row multiset (size klvl) and c the column
    contraction multiset (size k ≥ 2; k = 1 uses the in-kernel insert
    ranking instead)."""
    rep_u = tables(klvl, dim).rep_np()  # (n_u, klvl)
    rep_c = tables(k, dim).rep_np()  # (n_k, k)
    n_u, n_k = rep_u.shape[0], rep_c.shape[0]
    rfull = klvl + k
    lay = tables(rfull, dim).layout
    out = np.empty((n_u, n_k), np.int64)
    # chunk the column axis: the (n_u·chunk, rfull) sort buffer stays small
    ch = max(1, 2_000_000 // max(1, n_u))
    cols = np.empty((n_u, rfull), np.int64)
    for c0 in range(0, n_k, ch):
        for ci in range(c0, min(c0 + ch, n_k)):
            cols[:, :klvl] = rep_u
            cols[:, klvl:] = rep_c[ci]
            srt = np.sort(cols, axis=1)
            out[:, ci] = (
                lay.position_array(srt) if rfull > 1 else srt[:, 0]
            )
    return _i32(out)


@lru_cache(maxsize=None)
def _paired_jitted(ra, rb, k, dim, dt_str):
    """Memoized jitted pair-contraction program for one shape signature."""
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    n_out = t_out.n
    n_ka = comb.indep_size(ka, dim)
    n_kb = comb.indep_size(kb, dim)
    subsets = list(itertools.combinations(range(r_out), ka))
    n_sub = len(subsets)
    dt = jnp.dtype(dt_str)

    def level_pos(lvl_rank, part_T):
        # position of an already-sorted sub-multiset in its level layout
        if lvl_rank == 0:
            return jnp.zeros((part_T.shape[1],), jnp.int32)
        if lvl_rank == 1:
            return part_T[0].astype(jnp.int32)
        return tables(lvl_rank, dim).position_jnp_T(part_T)

    def expand(data, lvl_rank, pos_tbl, t_full):
        # F[u, c] = data[pos(sort(u ∪ c))] — (n_lvl, n_k)
        if lvl_rank == 0:
            return data.reshape(1, -1)
        if k == 1:
            rep_T = tables(lvl_rank, dim)._memo(
                "rep_T_i32",
                lambda: jnp.asarray(
                    tables(lvl_rank, dim).rep_np().astype(np.int32).T
                ),
            )
            sl = t_full.position_insert_jnp_T(rep_T)  # (n_lvl, d)
            return data[sl]
        return data[pos_tbl]

    def fn(a_data, b_data, pa_tbl, pb_tbl, rep_flat, gam):
        ct = jnp.result_type(a_data.dtype, b_data.dtype)
        FA = expand(a_data, ka, pa_tbl, tables(ra, dim)).astype(ct)
        FB = expand(b_data, kb, pb_tbl, tables(rb, dim)).astype(ct)
        FBw = FB * gam.astype(ct)[None, :]
        G = jax.lax.dot_general(
            FA, FBw,
            (((1,), (1,)), ((), ())),
            preferred_element_type=ct,
            precision=jax.lax.Precision.HIGHEST,
        )  # (n_ka, n_kb)
        Gf = G.reshape(-1)
        if r_out == 0:
            return Gf / n_sub
        rep_T = rep_flat.reshape(n_out, r_out).astype(jnp.int32).T
        acc = jnp.zeros((n_out,), dtype=ct)
        for S in subsets:
            Sc = tuple(i for i in range(r_out) if i not in S)
            pa = level_pos(ka, rep_T[list(S), :])
            pb = level_pos(kb, rep_T[list(Sc), :])
            acc = acc + Gf[pa * n_kb + pb]
        return acc / n_sub

    return jax.jit(fn)


def _paired_feasible(ra, rb, k, dim) -> bool:
    if k < 1:
        return False
    lim = _paired_limit()
    if lim <= 0:
        return False
    ka, kb = ra - k, rb - k
    n_k = comb.indep_size(k, dim)
    n_ka = comb.indep_size(ka, dim)
    n_kb = comb.indep_size(kb, dim)
    n_out = comb.indep_size(ka + kb, dim)
    return (
        n_ka * n_k <= lim
        and n_kb * n_k <= lim
        and n_ka * n_kb <= lim
        and n_out * max(1, ka + kb) <= lim
    )


def _combine_paired(af, bf, k):
    ra, rb, dim = af.rank, bf.rank, af.dim
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    tk = tables(k, dim)
    gam = tk._memo(
        "row_gamma_f32",
        lambda: jnp.asarray(
            comb.row_multiplicities(tk.rep_np()).astype(np.float32)
        ),
    )
    pa_tbl = (
        _expand_positions(ka, k, dim) if (k >= 2 and ka >= 1) else None
    )
    pb_tbl = (
        _expand_positions(kb, k, dim) if (k >= 2 and kb >= 1) else None
    )
    idt = _stream_idt(dim)
    if r_out > 0:
        rep_flat = t_out._memo(
            ("rep_flat", np.dtype(idt).name),
            lambda: jnp.asarray(
                t_out.rep_np().astype(idt).reshape(-1)
            ),
        )
    else:
        rep_flat = jnp.zeros((0,), jnp.int8)
    ct = jnp.result_type(af.dtype, bf.dtype)
    fn = _paired_jitted(ra, rb, k, dim, str(jnp.dtype(ct)))
    return fn(af.data, bf.data, pa_tbl, pb_tbl, rep_flat, gam)


def _streamed_block_elems() -> int:
    import os

    # Per-step element budget of the streamed body; not yet tuned for the
    # GPU (a larger block means fewer lax.map steps but larger temporaries).
    return int(os.environ.get("SYMTENSOR_STREAM_BLOCK_ELEMS", 2**22))


# Max gather-table entries tolerated as constants inside a TRACED program
# (each entry is an int32 in the MLIR: 2e6 ≈ 8 MB per table).
_TRACED_TABLE_LIMIT = 2_000_000


def _table_guard_limit() -> int:
    from ..config import config

    return config.max_table_entries


def _stream_pos_of_T(t_fmt, part_T, rank_part, creps_T, k, n_k):
    """Gather positions for one subset of the streamed tensordot block:
    part_T carries (rank_part − k, n_k, B) output-part index components on
    the leading axis; append the contraction multiset, sort along axis 0
    (a compare-exchange network over (n_k, B) planes), rank."""
    if k == 1 and rank_part >= 2:
        # single-element insert: creps are the d singletons 0..d−1 in
        # colex order, so the sort-free insert ranking applies
        # (tables.position_insert_jnp_T) — no (rank, n_k, B) sort
        # stack, no per-element Pascal gathers
        return t_fmt.position_insert_jnp_T(part_T[:, 0, :]).T
    full_T = jnp.concatenate(
        [
            part_T,
            jnp.broadcast_to(
                creps_T[:, :, None], (k, n_k, part_T.shape[2])
            ),
        ],
        axis=0,
    )
    full_T = jnp.sort(full_T, axis=0)
    if rank_part == 1:
        return full_T[0]
    return t_fmt.position_jnp_T(full_T)


@lru_cache(maxsize=None)
def _streamed_jitted(ra, rb, k, dim, dt_str, B, nblk, trim=True):
    """Memoized jitted streaming program for one shape signature: a fresh
    trace per eager call costs seconds of host time (all retracing).

    trim=False returns the padded (nblk·B,) vector — used by the sharded
    variant, whose per-device bodies cover only a block slice."""
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    t_a, t_b = tables(ra, dim), tables(rb, dim)
    n_out = t_out.n
    n_k = comb.indep_size(k, dim) if k > 0 else 1
    subsets = list(itertools.combinations(range(r_out), ka))
    n_sub = len(subsets)
    dt = jnp.dtype(dt_str)

    def pos_of_T(t_fmt, part_T, rank_part, creps_T):
        return _stream_pos_of_T(t_fmt, part_T, rank_part, creps_T, k, n_k)

    def fn(a_data, b_data, rep_pad, creps_T, gam):
        gam = gam.astype(dt)

        def body(rep_blk_flat):  # (B·r_out,)
            rep_T = (
                rep_blk_flat.reshape(B, r_out).astype(jnp.int32).T
                if r_out
                else jnp.zeros((0, B), jnp.int32)
            )  # (r_out, B)
            acc = jnp.zeros((B,), dtype=dt)
            for S in subsets:
                Sc = tuple(i for i in range(r_out) if i not in S)
                ia = jnp.broadcast_to(
                    rep_T[list(S), None, :], (ka, n_k, B)
                )
                ib = jnp.broadcast_to(
                    rep_T[list(Sc), None, :], (kb, n_k, B)
                )
                pa = pos_of_T(t_a, ia, ra, creps_T)  # (n_k, B)
                pb = pos_of_T(t_b, ib, rb, creps_T)
                term = jnp.einsum(
                    "c,cb->b", gam, a_data[pa] * b_data[pb],
                    precision=value_prec(dt),
                )
                acc = acc + term
            return acc / n_sub

        out = jax.lax.map(body, rep_pad.reshape(nblk, B * r_out))
        out = out.reshape(-1)
        return out[:n_out] if trim else out

    return jax.jit(fn)


def _stream_idt(dim):
    import os as _os

    _idt_env = _os.environ.get("SYMTENSOR_STREAM_IDT", "")
    if _idt_env:
        return np.dtype(_idt_env).type
    return np.int8 if dim <= 127 else (
        np.int16 if dim <= 32767 else np.int32
    )


def _combine_streamed(af, bf, k):
    """Streaming symmetrized outer/tensordot: output computed in fixed-size
    blocks with gather positions built *in-kernel* by the closed-form gflat
    ranking — no (n_subsets·n_k·n_out) host tables, so arbitrarily large
    outputs run in bounded memory (the round-1 version raised MemoryError
    past the table guard). One lax.map body = one compiled program, and the
    jitted program plus its device tables are memoized per shape signature.

        out[K] = (1/C(r_out, ka)) Σ_{S} Σ_C γ_C · A[sort(K_S∪C)]·B[sort(C∪K_∖S)]

    (reference semantics symalg.py:424-459; k = 0 degenerates to the
    position-subset outer identity.)"""
    ra, rb, dim = af.rank, bf.rank, af.dim
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    n_out = t_out.n
    # Layout discipline: (N, small-rank) index tables are uploaded FLAT and
    # index components live on LEADING axes in-kernel, so no array has a
    # tiny minor dimension that a tiled device layout would pad (see
    # ops/basis_change.py for the same pattern).
    idt = _stream_idt(dim)
    tk = tables(k, dim)
    if k > 0:
        creps_T = tk._memo(
            "creps_T", lambda: jnp.asarray(tk.rep_np().astype(np.int32).T)
        )  # (k, n_k)
        gam = tk.multiplicity
        n_k = creps_T.shape[1]
    else:
        creps_T = jnp.zeros((0, 1), jnp.int32)
        gam = jnp.ones((1,), af.dtype)
        n_k = 1
    subsets_n = comb.binom(r_out, ka)

    # Block size budgets the *peak* per-step intermediates, not just one
    # index array: each of the n_sub subset terms materializes sort and
    # gather temporaries of shape (rank, n_k, B). Undercounting this ran
    # out of device memory at rank-3×rank-3 dim-100.
    per_elem = max(1, n_k * (ka + kb + k)) * max(1, min(subsets_n, 4))
    B = max(
        1,
        min(
            n_out,
            _streamed_block_elems() // per_elem,
        ),
    )
    nblk = -(-n_out // B)
    pad = nblk * B - n_out

    def build_rep_pad():
        rep_flat = jnp.asarray(
            (
                t_out.rep_np()
                if r_out > 0
                else np.zeros((1, 0), np.int64)
            ).astype(idt).reshape(-1)
        )
        if pad:
            rep_flat = jnp.concatenate(
                [rep_flat, jnp.zeros((pad * r_out,), rep_flat.dtype)]
            )
        return rep_flat

    rep_pad = t_out._memo(("rep_pad", np.dtype(idt).name, B), build_rep_pad)

    fn = _streamed_jitted(
        ra, rb, k, dim, str(jnp.dtype(af.dtype)), int(B), int(nblk)
    )
    return fn(af.data, bf.data, rep_pad, creps_T, gam)


def tensordot(a, b, axes=1, stream: bool = None):
    """Symmetrized tensordot (reference symalg.tensordot, symalg.py:424):
    contract `axes` index pairs, then symmetrize — computed directly in the
    compressed domain. `axes` may be an int or np-style axis lists (which
    collapse to their count: axis identity is immaterial for symmetric
    tensors). Falls back to a streaming blocked path (bounded memory, one
    compiled program) when the gather tables would exceed the table guard;
    `stream` forces (True) or forbids (False) that path."""
    if not isinstance(axes, int):
        ax_a, ax_b = axes
        ax_a = (ax_a,) if isinstance(ax_a, int) else tuple(ax_a)
        ax_b = (ax_b,) if isinstance(ax_b, int) else tuple(ax_b)
        if len(ax_a) != len(ax_b):
            raise ValueError("axes lists must have equal length")
        axes = len(ax_a)
    if axes == 0:
        return symmetric_outer(a, b, "multiply")

    if (
        isinstance(a, SymmetricTensor)
        and isinstance(b, SymmetricTensor)
        and a.format == b.format == "decomp"
    ):
        try:
            out = a.tensordot_decomp(b, axes=axes)
        except NotImplementedError:
            from ..utils.profiling import count_fallback

            count_fallback(
                "tensordot.decomp_to_packed",
                f"(axes={axes} with multi-group decomp operands)",
            )
            out = None
        if out is not None:
            if isinstance(out, SymmetricTensor):
                return out
            return FlatSymmetricTensor._raw(0, 1, out.reshape(1))

    af, _ = _as_flat(a)
    bf, _ = _as_flat(b)
    ra, rb, k = af.rank, bf.rank, axes
    if k > min(ra, rb):
        raise ValueError(
            f"cannot contract {k} axes between ranks {ra} and {rb}"
        )
    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim = af.dim
    r_out = ra + rb - 2 * k

    # Pair-contraction route: collapses the Σ_c γ_c A[·]B[·] inner sum into
    # one GEMM over small expanded matrices, leaving n_sub gathers per
    # output element (vs 2·n_sub·n_k) — preferred whenever its F/G/rep
    # tables fit.  Eager-only: its memoized device tables would bake into a
    # caller's traced program as constants.
    if (
        stream is None
        and _paired_feasible(ra, rb, k, dim)
        and not isinstance(af.data, jax.core.Tracer)
        and not isinstance(bf.data, jax.core.Tracer)
    ):
        acc = _combine_paired(af, bf, k)
        if r_out == 0:
            out = FlatSymmetricTensor._raw(0, 1, acc.reshape(1))
        else:
            out = FlatSymmetricTensor._raw(r_out, dim, acc)
        return _wrap_result(out, a, b)

    # table-size gate: past the guard, stream output blocks with in-kernel
    # closed-form positions instead of raising
    if stream is None:
        n_out_sz = comb.indep_size(r_out, dim)
        n_k_sz = comb.indep_size(k, dim)
        n_sub_sz = comb.binom(r_out, ra - k)
        entries = 2 * n_sub_sz * n_k_sz * n_out_sz
        stream = entries > _table_guard_limit() or (
            # see symmetric_outer: avoid baking huge gather tables into a
            # caller's traced program
            entries > _TRACED_TABLE_LIMIT
            and (
                isinstance(af.data, jax.core.Tracer)
                or isinstance(bf.data, jax.core.Tracer)
            )
        )
    if stream:
        acc = _combine_streamed(af, bf, k)
        if r_out == 0:
            out = FlatSymmetricTensor._raw(0, 1, acc.reshape(1))
        else:
            out = FlatSymmetricTensor._raw(r_out, dim, acc)
        return _wrap_result(out, a, b)

    A_tab, B_tab, gam, n_sub = _tensordot_tables(ra, rb, k, dim)
    gam = gam.astype(af.data.dtype)
    acc = None
    for s in range(n_sub):
        # (n_k, n_out) gathers; weighted sum over contraction multisets
        term = jnp.einsum(
            "c,co->o", gam, af.data[A_tab[s]] * bf.data[B_tab[s]],
            precision=value_prec(af.data.dtype),
        )
        acc = term if acc is None else acc + term
    acc = acc / n_sub
    if r_out == 0:
        out = FlatSymmetricTensor._raw(0, 1, acc.reshape(1))
    else:
        out = FlatSymmetricTensor._raw(r_out, dim, acc)
    return _wrap_result(out, a, b)
