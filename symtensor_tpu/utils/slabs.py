"""Insertion-depth slab decomposition of the basis-change gather.

Host-side planner for docs/design_slab_gather.md: each basis-change step
gathers, for every child multiset ``j`` (size k) and every original
index ``i``, the parent column at the level position of
``sort(j ∪ {i})`` (size k+1).  The slab recursion below is derived in
COLEX order; plain LEX order (ascending multisets) is its exact mirror
under value complement — use ``plan_lex`` for lex-order descriptors
(same contiguity, same statistics; see its docstring for the
bijection).

**Production-layout caveat**: the gflat storage order
(utils.combinatorics.GflatLayout) equals lex only for rank ≤ 3; for
rank ≥ 4 it is the grouped order [colex head | group j | tail
triangle], whose insert-contiguity structure is case-based and RICHER
than lex (the ``i < head-max`` case keeps whole tail triangles
contiguous — runs of length T_g ≈ C(d−g+1, 2)).  See the design doc's
"gflat case analysis" section; the lex planner here is the verified
core engine that the gflat planner's head-level recursion reuses.
In colex the operator is

    sl(j, i) = colex_rank(sort(j ∪ {i}))          (size k+1)

On the previous accelerator the *form* of this access decided its cost:
element gathers ran far below memory bandwidth while contiguous runs
moved at full rate.  This module decomposes the
(j, i) incidence set into **contiguous slabs**:

- depth δ=0 (``i ≥ max(j)``): for fixed i, as j runs over the colex
  prefix ``{j : max(j) ≤ i}`` (= child rows ``[0, N_k(i+1))``), the
  parent positions are consecutive:

      sl(j, i) = C(i+k, k+1) + rank_k(j)

  → ONE contiguous parent run per (subblock, column i).
- depth δ≥1 (``i < max(j) = M``): with j = (g, M), sort(j∪{i}) =
  (sort(g∪{i}), M); both parent and child positions live in the
  contiguous max=M subblock pair, where the SAME operator recurs at
  size k−1 with insertions capped at ``i < M``.  Colex ranks are
  dimension-independent, so sub-ranks are global ranks minus the
  subblock base.

Every pair (j, i) with i < d is covered exactly once (δ is a function
of the pair); ``tests/test_slabs.py`` proves this exhaustively against
the sort-based oracle for small (k, d).

The planner emits flat numpy descriptor arrays bucketed by slab length
— the shape the future device kernel consumes as dynamic_slice runs —
plus a ``coverage`` diagnostic (fraction of incidences in slabs of at
least a given length, i.e. the fraction that moves at DMA rate).

Reference: the operator itself is the insert map of
/root/repo/symtensor_tpu/ops/basis_change.py (step equation in its
module docstring); the reference library has no analog (it densifies,
/root/reference/symtensor/symalg.py:475-496).
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np

from . import combinatorics as comb


class Slab(NamedTuple):
    """One contiguous gather run.

    Children ``[child_start, child_start + length)`` of the step all
    read their column-``i`` parent from
    ``parent[parent_start + (rank - child_start)]`` — i.e. column i of
    the gather matrix restricted to that child range is the contiguous
    parent run ``[parent_start, parent_start + length)``.
    """

    child_start: int
    i: int
    parent_start: int
    length: int
    depth: int


def _rec(kk: int, dim_sub: int, i_up: int, child_base: int,
         parent_base: int, depth: int) -> Iterator[Slab]:
    """Slab recursion over one (sub)block in COLEX coordinates.

    dim_sub: child values run over [0, dim_sub); i_up: insertions of
    this subblock are capped at i < i_up (= dim at the top, = the
    just-peeled max below it — peeling happened only when i < max).
    """
    # δ=0 slabs: column i covers the child colex prefix
    # {j : max(j) ≤ i} = rows [0, N_kk(i+1)).
    for i in range(i_up):
        length = comb.multiset_count(i + 1, kk)  # N_kk(i+1)
        if length == 0:
            continue
        # sl(j, i) = C(i+kk, kk+1) + rank_kk(j): run starts at j's
        # rank 0
        yield Slab(
            child_base,
            i,
            parent_base + comb.binom(i + kk, kk + 1),
            length,
            depth,
        )
    # recursion: children with max = M (ANY M < dim_sub, including
    # M ≥ i_up — the child may repeat the peeled max) pair with
    # parents with max = M; within the pair the operator recurs at
    # size kk−1 over values ≤ M with insertions capped at i < M.
    if kk == 0:
        return
    for M in range(1, dim_sub):
        # child subblock base: first size-kk multiset with max M
        cb = child_base + comb.multiset_count(M, kk)
        # parent subblock base: first size-(kk+1) multiset w/ max M
        pb = parent_base + comb.multiset_count(M, kk + 1)
        yield from _rec(kk - 1, M + 1, M, cb, pb, depth + 1)


def iter_slabs(k: int, d: int, i_up: Optional[int] = None) -> Iterator[Slab]:
    """Yield every slab of the size-k → size-(k+1) insert operator.

    Covers each (child multiset j of size k over values < d,
    insertion value i < i_up) pair exactly once (i_up defaults to d).
    k = 0 is the root step (single empty child row; parent run is the
    whole size-1 level).  The capped form (i_up < d) is the head-level
    operator of the production case-D planner (`plan_gflat_d`).
    """
    yield from _rec(k, d, d if i_up is None else i_up, 0, 0, 0)


def plan(k: int, d: int, min_run: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten the slab set into device-uploadable descriptor arrays.

    Returns ``(runs, tail)``:

    - ``runs``: int64 array (n_slabs, 4) of
      (child_start, i, parent_start, length) for slabs with
      ``length ≥ min_run`` — the DMA-rate portion;
    - ``tail``: int64 array (n_tail, 3) of (child_rank, i, parent_pos)
      element incidences from slabs shorter than ``min_run`` — handed
      to the element-gather kernel.
    """
    runs, tail = [], []
    for s in iter_slabs(k, d):
        if s.length >= min_run:
            runs.append((s.child_start, s.i, s.parent_start, s.length))
        else:
            for t in range(s.length):
                tail.append((s.child_start + t, s.i, s.parent_start + t))
    runs_a = np.asarray(runs, np.int64).reshape(-1, 4)
    tail_a = np.asarray(tail, np.int64).reshape(-1, 3)
    return runs_a, tail_a


def plan_lex(
    k: int, d: int, min_run: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """`plan` mapped into plain LEX order on ascending multisets.

    Lex coincides with the production gflat layout only for parent rank
    (k+1) ≤ 3 (see module docstring); it is also the order of
    `itertools.combinations_with_replacement` and of `rep_np()` row
    enumeration.  The slab recursion is derived in colex; the two are
    exact mirrors under the value complement ``m → d−1−m`` (re-sorted):

        pos_lex(j)    = N_k − 1 − colex_rank(complement(j))
        sl_lex(j, i)  = N_{k+1} − 1 − sl_colex(complement(j), d−1−i)

    A colex slab (child c₀, i, parent p₀, length L) with the ascending
    pairing c₀+t ↔ p₀+t therefore maps to the lex slab
    (N_k − c₀ − L, d−1−i, N_{k+1} − p₀ − L, L) with the SAME ascending
    pairing — contiguity and run lengths are preserved exactly, so
    coverage() statistics carry over to lex order unchanged.
    """
    runs_c, tail_c = plan(k, d, min_run)
    n_child = comb.multiset_count(d, k)
    n_par = comb.multiset_count(d, k + 1)
    runs = runs_c.copy()
    if runs.size:
        runs[:, 0] = n_child - runs_c[:, 0] - runs_c[:, 3]
        runs[:, 1] = d - 1 - runs_c[:, 1]
        runs[:, 2] = n_par - runs_c[:, 2] - runs_c[:, 3]
    tail = tail_c.copy()
    if tail.size:
        tail[:, 0] = n_child - 1 - tail_c[:, 0]
        tail[:, 1] = d - 1 - tail_c[:, 1]
        tail[:, 2] = n_par - 1 - tail_c[:, 2]
    return runs, tail


def plan_gflat_d(
    k: int, d: int, min_run: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Case-D slabs of the insert operator in the PRODUCTION layout.

    The gflat level layout (utils.combinatorics.GflatLayout, rank ≥ 3)
    is [colex head | group g = m[rank−3] | tail triangle].  For
    insertions ``i < g`` (case D of the design doc's gflat analysis —
    49.5% of all incidences at the rank-6 root step), the parent is
    [sort(head ∪ {i}) | g | same tail]: the tail triangle block of size
    T_g = C(d−g+1, 2) rides along UNCHANGED, so every head-level colex
    slab of L heads becomes one contiguous production run of L·T_g
    elements.  The head-level operator is exactly the capped colex
    recursion ``iter_slabs(k−3, g+1, i_up=g)`` — the exhaustively
    verified core.

    Requires k ≥ 3 (for k ≤ 2 the layout is lex/triangular — use
    `plan_lex`).  Returns (runs, tail) in `plan`'s format, covering
    exactly the i < g incidences; cases A/B/C are separate planners.
    ``min_run`` is in PRODUCTION elements (post-×T_g), so even
    head-level tail elements usually clear it.
    """
    if k < 3:
        raise ValueError("plan_gflat_d requires k ≥ 3 (gflat child "
                         "layout); use plan_lex below that")
    kh = k - 3
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    runs, tail = [], []
    for g in range(1, d):
        T = int(lay_c.T[g])
        cb = int(lay_c.group_off[g])
        pb = int(lay_p.group_off[g])
        for s in _rec(kh, g + 1, g, 0, 0, 0):
            length = s.length * T
            if length >= min_run:
                runs.append((
                    cb + s.child_start * T,
                    s.i,
                    pb + s.parent_start * T,
                    length,
                ))
            else:
                for t in range(length):
                    tail.append((
                        cb + s.child_start * T + t,
                        s.i,
                        pb + s.parent_start * T + t,
                    ))
    runs_a = np.asarray(runs, np.int64).reshape(-1, 4)
    tail_a = np.asarray(tail, np.int64).reshape(-1, 3)
    return runs_a, tail_a


def plan_gflat_c(
    k: int, d: int, min_run: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Case-C slabs (g ≤ i < ta) in the PRODUCTION layout.

    Parent = [head, g | G'=i | (ta−i, tb−i)]: the child tail rows with
    ta > i map row-for-row (equal lengths: parent side' = d−i, parent
    row a−(i−g) has length side−a) onto the TAIL sub-triangle of the
    parent group-i block, so per (head-rank h, g, i) the covered
    incidences are ONE contiguous parent run of C(side−a₀+1, 2)
    elements (a₀ = i−g+1), paired with the contiguous child row-suffix
    — the same (child varies, i fixed) column-run semantics as case D,
    hence the same (child_start, i, parent_start, length) record.

    ~Σ_g P_k[g]·(d−1−g) descriptors (4.3e6 at k=5, d=100, avg run
    ~350 elements).  Requires k ≥ 3.
    """
    if k < 3:
        raise ValueError("plan_gflat_c requires k ≥ 3 (gflat child "
                         "layout); use plan_lex below that")
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    runs, tail = [], []
    for g in range(d - 1):
        side = d - g
        T = int(lay_c.T[g])
        n_heads = int(lay_c.P[g])
        cOff = int(lay_c.group_off[g])
        # parent head' = [head, g]: colex rank = colex(head) + the g
        # appended as the new max ⇒ rank' = C(g + kh, kh + 1) + h for
        # head colex rank h (kh = k−3): heads are ≤ g so appending g
        # keeps sortedness, and the colex closed form adds the last-slot
        # term.  (Same identity as the δ=0 slab start.)
        kh = k - 3
        hp_base = comb.binom(g + kh, kh + 1)
        for i in range(g, d - 1):
            a0 = i - g + 1
            if a0 >= side:
                break
            length = comb.binom(side - a0 + 1, 2)
            # child row-suffix start: local tri offset of row a0
            c_local = T - length
            # parent: group-i block, tail sub-triangle = last `length`
            # elements of the (head', i) tri block
            T_p = int(lay_p.T[i])
            pOff = int(lay_p.group_off[i])
            for h in range(n_heads):
                cs = cOff + h * T + c_local
                ps = pOff + (hp_base + h) * T_p + (T_p - length)
                if length >= min_run:
                    runs.append((cs, i, ps, length))
                else:
                    for t in range(length):
                        tail.append((cs + t, i, ps + t))
    runs_a = np.asarray(runs, np.int64).reshape(-1, 4)
    tail_a = np.asarray(tail, np.int64).reshape(-1, 3)
    return runs_a, tail_a


def plan_gflat_a(k: int, d: int) -> np.ndarray:
    """Case-A patches (i ≥ tb) in the PRODUCTION layout.

    Parent = [head, g | G'=ta | (tb−ta, i−ta)].  For one (head-rank h,
    g, a) the incidences {(child b ∈ [a, side), i ∈ [tb, d))} cover the
    COMPLETE parent tri block at (head'=[head,g], group'=ta) — one
    contiguous run of T(side−a) = C(side−a+1, 2) elements.

    Returns an int64 (n_patches, 4) array of rows
    (child_start, n, parent_start, ta) with the semantics

        for t in [0, n):   # child row b = a+t
            child  = child_start + t
            for u in [0, n−t):
                incidence (child, i = ta+t+u) ← parent_start
                    + tri_off_n(t) + u     # tri_off_n(t) = t·n − t(t−1)/2

    ~Σ_g P_k[g]·(d−g) patches (4.3e6 at k=5, d=100).  Case B reads the
    SAME parent block (transposed roles) — one tile fetch serves both.
    Requires k ≥ 3.
    """
    if k < 3:
        raise ValueError("plan_gflat_a requires k ≥ 3 (gflat child "
                         "layout); use plan_lex below that")
    kh = k - 3
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    patches = []
    for g in range(d):
        side = d - g
        T = int(lay_c.T[g])
        n_heads = int(lay_c.P[g])
        cOff = int(lay_c.group_off[g])
        hp_base = comb.binom(g + kh, kh + 1)
        tri_off = 0
        for a in range(side):
            n = side - a
            ta = g + a
            T_p = int(lay_p.T[ta])
            assert T_p == comb.binom(n + 1, 2)
            pOff = int(lay_p.group_off[ta])
            for h in range(n_heads):
                patches.append((
                    cOff + h * T + tri_off,
                    n,
                    pOff + (hp_base + h) * T_p,
                    ta,
                ))
            tri_off += n
    return np.asarray(patches, np.int64).reshape(-1, 4)


def expand_patches_a(patches: np.ndarray):
    """Expand case-A patch records to (child, i, parent_pos) triples —
    test/oracle helper (the kernel consumes patches directly)."""
    out = []
    for cs, n, ps, ta in patches:
        off = 0
        for t in range(n):
            for u in range(n - t):
                out.append((cs + t, ta + t + u, ps + off + u))
            off += n - t
    return out


def plan_gflat_b(
    k: int, d: int, min_run: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Case-B slabs (ta ≤ i < tb) in the PRODUCTION layout.

    Same parent tri block as case A with TRANSPOSED tail roles:
    tail' = (i−ta, tb−ta), row v = i−ta, column b−a > v.  For fixed
    (head h, g, a, v): children b ∈ (a+v, side) are a contiguous
    segment and parents are the row-v strict suffix — standard
    (child varies, i fixed) column runs in `plan`'s (runs, tail)
    format.  Run lengths are n−v−1 (avg ~(d−g)/2); at full scale these
    descriptors are generated in-kernel from the case-A patch table,
    but the explicit form here is the small-scale oracle.
    """
    if k < 3:
        raise ValueError("plan_gflat_b requires k ≥ 3 (gflat child "
                         "layout); use plan_lex below that")
    kh = k - 3
    lay_c = comb.gflat_layout(k, d)
    lay_p = comb.gflat_layout(k + 1, d)
    runs, tail = [], []
    for g in range(d):
        side = d - g
        T = int(lay_c.T[g])
        n_heads = int(lay_c.P[g])
        cOff = int(lay_c.group_off[g])
        hp_base = comb.binom(g + kh, kh + 1)
        tri_off = 0
        for a in range(side):
            n = side - a
            ta = g + a
            T_p = int(lay_p.T[ta])
            pOff = int(lay_p.group_off[ta])
            p_tri = 0
            for v in range(n - 1):
                length = n - v - 1
                for h in range(n_heads):
                    cs = cOff + h * T + tri_off + v + 1
                    ps = pOff + (hp_base + h) * T_p + p_tri + 1
                    if length >= min_run:
                        runs.append((cs, ta + v, ps, length))
                    else:
                        for t in range(length):
                            tail.append((cs + t, ta + v, ps + t))
                p_tri += n - v
            tri_off += n
    runs_a = np.asarray(runs, np.int64).reshape(-1, 4)
    tail_a = np.asarray(tail, np.int64).reshape(-1, 3)
    return runs_a, tail_a


def coverage(
    k: int, d: int, min_run: int, min_rows: int = 1
) -> Tuple[float, int, int]:
    """(fraction of incidences in runs ≥ min_run, n_runs, n_tail_elems).

    The fraction is the share of the gather that moves at DMA rate when
    the kernel slices runs of at least ``min_run`` elements; the
    remainder stays on the element-gather path.
    ``min_rows`` prunes the recursion: subblocks with fewer child rows
    are handed whole to the element-gather tail (their child AND parent
    ranges are contiguous, so the tail pass is range-restricted, not
    per-pair).

    Closed form: all subblocks with the same (kk, i_up) signature have
    identical local structure (colex ranks are dimension-independent),
    so the recursion memoizes on the signature instead of enumerating
    the ~N_δ(d) subblocks (92M at k=5, d=100 — the "subblock explosion"
    of docs/design_slab_gather.md).
    """
    from functools import lru_cache

    @lru_cache(maxsize=None)
    def stats(kk: int, dim_sub: int, i_up: int) -> Tuple[int, int, int]:
        run_e = n_r = tail = 0
        for i in range(i_up):
            ln = comb.multiset_count(i + 1, kk)
            if ln == 0:
                continue
            if ln >= min_run:
                run_e += ln
                n_r += 1
            else:
                tail += ln
        if kk > 0:
            for M in range(1, dim_sub):
                rows = comb.multiset_count(M + 1, kk - 1)
                sub_total = rows * M
                if sub_total == 0:
                    continue
                if rows < min_rows:
                    tail += sub_total
                else:
                    re, nr, tl = stats(kk - 1, M + 1, M)
                    run_e += re
                    n_r += nr
                    tail += tl
        return run_e, n_r, tail

    total = comb.multiset_count(d, k) * d
    run_e, n_r, tail = stats(k, d, d)
    assert run_e + tail == total
    return run_e / total, n_r, tail
