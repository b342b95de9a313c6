"""Static device-resident index tables, cached per (rank, dim).

The reference builds per-(rank,dim) index→position dictionaries lazily on the
host (``PosRegistry``, symtensor/permcls_symtensor.py:422) and walks Python
generators in hot paths. On an accelerator everything combinatorial must be
*static*: either closed-form arithmetic executed in jnp (positions), or
precomputed int32 arrays living in device memory (gather maps). This module owns those arrays.

All tables are cached by (rank, dim) — identical Python object identity on
reuse, so jit tracing does not recompile.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import numpy as np
import jax.numpy as jnp

from ..config import config
from . import combinatorics as comb


def _check_table(entries: int, what: str) -> None:
    if entries > config.max_table_entries:
        raise MemoryError(
            f"static table '{what}' would need {entries:,} entries "
            f"(> config.max_table_entries = {config.max_table_entries:,}); "
            "use the streaming/blocked path or raise the limit"
        )


def _i32(x: np.ndarray) -> jnp.ndarray:
    assert np.all(x >= 0)
    if x.size and int(x.max()) >= 2**31:
        raise OverflowError("index table exceeds int32 range")
    # Tables are memoized across calls; if the first build happens inside a
    # trace, a trace-bound constant would be cached and leak into later
    # traces (UnexpectedTracerError). Force an eager device array.
    with jax.ensure_compile_time_eval():
        return jnp.asarray(x.astype(np.int32))


class Tables:
    """Lazily-built static tables for one (rank, dim). Host layout data is
    always available; device arrays are built on first use and memoized."""

    def __init__(self, rank: int, dim: int):
        self.rank = rank
        self.dim = dim
        self.n = comb.indep_size(rank, dim)
        self.layout = comb.gflat_layout(rank, dim) if rank >= 2 else None
        self._cache: dict = {}

    # ------------------------------------------------------------------ util

    def _memo(self, key, builder):
        if key not in self._cache:
            # Tables may be built lazily inside a jit trace; force concrete
            # (compile-time) evaluation so no tracer leaks into the cache.
            import jax

            with jax.ensure_compile_time_eval():
                self._cache[key] = builder()
        return self._cache[key]

    # --------------------------------------------------------------- scalars

    @property
    def perm_classes(self) -> Tuple[comb.SigmaClass, ...]:
        """All σ-classes of this rank, in canonical enumeration order —
        including classes that are empty at this dim (those needing more
        distinct values than dim has). Class ids elsewhere in the tables
        index into this unfiltered tuple; PermClsSymmetricTensor._class_keys
        is where empty classes get filtered out of storage."""
        return comb.perm_classes(self.rank)

    # ------------------------------------------------------- device layout

    @property
    def pascal(self) -> jnp.ndarray:
        """Pascal triangle C(n, k) for n ≤ dim+rank+1, k ≤ rank+1, float-free
        int32 device table used by the traced position formula."""

        def build():
            N = self.dim + self.rank + 2
            K = self.rank + 2
            p = np.zeros((N, K), dtype=np.int64)
            p[:, 0] = 1
            for nn in range(1, N):
                for kk in range(1, K):
                    p[nn, kk] = p[nn - 1, kk - 1] + p[nn - 1, kk]
            return _i32(np.minimum(p, 2**31 - 1))

        return self._memo("pascal", build)

    @property
    def group_off(self) -> jnp.ndarray:
        return self._memo("group_off", lambda: _i32(self.layout.group_off))

    @property
    def group_T(self) -> jnp.ndarray:
        return self._memo("group_T", lambda: _i32(self.layout.T))

    @property
    def tri_off(self) -> jnp.ndarray:
        return self._memo("tri_off", lambda: _i32(self.layout.tri_off))

    # ------------------------------------------------------ traced position

    def position_jnp(self, sorted_idx: jnp.ndarray) -> jnp.ndarray:
        """Traced gflat position for ascending multi-indices.

        sorted_idx: (..., rank) int array → (...,) int32. Pure arithmetic +
        tiny Pascal gathers; works under jit/vmap (replaces the reference's
        host-side dict lookup, symtensor/permcls_symtensor.py:448).
        """
        r, d = self.rank, self.dim
        idx = sorted_idx.astype(jnp.int32)
        if r == 1:
            return idx[..., 0]
        if r == 2:
            a, b = idx[..., 0], idx[..., 1]
            return a * (2 * d - a + 1) // 2 + (b - a)
        j = idx[..., r - 3]
        head = idx[..., : r - 3]
        # colex rank: Σ_t C(h_t + t, t+1)
        hrank = jnp.zeros(idx.shape[:-1], dtype=jnp.int32)
        for t in range(r - 3):
            hrank = hrank + self.pascal[head[..., t] + t, t + 1]
        a = idx[..., r - 2] - j
        b = idx[..., r - 1] - j
        side = d - j
        tri = a * (2 * side - a + 1) // 2 + (b - a)
        return self.group_off[j] + hrank * self.group_T[j] + tri

    def position_jnp_T(self, sorted_idx_T: jnp.ndarray) -> jnp.ndarray:
        """position_jnp with the index components stacked on the LEADING
        axis: (rank, ...) → (...,) int32.  A tiled device layout pads a
        (N, rank) index array's short minor axis; the transposed layout
        keeps the big axis minor."""
        r, d = self.rank, self.dim
        idx = sorted_idx_T.astype(jnp.int32)
        if r == 1:
            return idx[0]
        if r == 2:
            a, b = idx[0], idx[1]
            return a * (2 * d - a + 1) // 2 + (b - a)
        j = idx[r - 3]
        hrank = jnp.zeros(idx.shape[1:], dtype=jnp.int32)
        for t in range(r - 3):
            hrank = hrank + self.pascal[idx[t] + t, t + 1]
        a = idx[r - 2] - j
        b = idx[r - 1] - j
        side = d - j
        tri = a * (2 * side - a + 1) // 2 + (b - a)
        return self.group_off[j] + hrank * self.group_T[j] + tri

    @staticmethod
    def _binom_shift(x: jnp.ndarray, m: int) -> jnp.ndarray:
        """C(x + m - 1, m) as closed-form int32 arithmetic for small m —
        replaces the per-element Pascal-table gathers on hot paths (the
        polynomial is pure elementwise arithmetic).  Falls back to None for m >= 4 (callers then gather)."""
        if m == 1:
            return x
        if m == 2:
            return x * (x + 1) // 2
        if m == 3:
            return x * (x + 1) * (x + 2) // 6
        return None

    def position_base_jnp_T(self, rep_T: jnp.ndarray) -> jnp.ndarray:
        """Leaf-emit base positions: for ascending reps (rank−1 components)
        the gflat position of sort(rep ∪ {b}) for any b ≥ max(rep) is
        EXACTLY ``base + b`` — children of a parent occupy consecutive
        slots in their tri row.  rep_T: (rank−1, N) int → (N,) int32.

        All head-rank Pascal terms use closed-form polynomials
        (`_binom_shift`), so the only memory op is the (dim,)-table
        group_off gather; everything else is elementwise arithmetic on
        (N,)."""
        r, d = self.rank, self.dim
        if r == 1:
            return jnp.zeros(rep_T.shape[1:], dtype=jnp.int32)
        rep = rep_T.astype(jnp.int32)
        if r == 2:
            a = rep[0]
            return a * (2 * d - a + 1) // 2 - a
        g = rep[r - 3]
        hrank = jnp.zeros(rep.shape[1:], dtype=jnp.int32)
        for t in range(r - 3):
            # C(rep_t + t, t+1) = C(x + m − 1, m) at x = rep_t, m = t+1
            term = self._binom_shift(rep[t], t + 1)
            if term is None:
                term = self.pascal[rep[t] + t, t + 1]
            hrank = hrank + term
        a = rep[r - 2] - g
        side = d - g
        T_g = side * (side + 1) // 2
        tri_base = a * (2 * side - a + 1) // 2 - a - g
        return self.group_off[g] + hrank * T_g + tri_base

    def position_insert_jnp_T(self, rep_T: jnp.ndarray) -> jnp.ndarray:
        """gflat positions of sort(rep ∪ {i}) for every i ∈ [0, d),
        without sorting or per-element table gathers.

        rep_T: (K−1, seg) int32, columns ascending (K = self.rank ≥ 2).
        Returns (seg, d) int32.

        Decomposition by the insertion slot cnt = #{rep_s ≤ i}: the
        merged multiset's head / group element / tail triangle are then
        known per case, so positions reduce to per-rep prefix sums (a few
        tiny Pascal gathers of (seg,)) plus ~2K masked multiply-add
        planes over (seg, d) — all elementwise.  The previous on-the-fly path
        sorted a (K, seg, d) stack and ranked it with K Pascal gathers
        *per element*, which dominated level-0 basis-change chunks."""
        K, d = self.rank, self.dim
        k = K - 1
        rep = rep_T.astype(jnp.int32)  # (k, seg)
        seg = rep.shape[1]
        i_row = jnp.arange(d, dtype=jnp.int32)[None, :]  # (1, d)
        if K == 1:  # empty rep: the merged multiset is just (i)
            return jnp.broadcast_to(i_row, (seg, d))
        # insertion slot per (column, i)
        cnt = (rep[:, :, None] <= i_row[None, :, :]).sum(0).astype(
            jnp.int32
        )  # (seg, d)

        if K == 2:
            a = jnp.minimum(rep[0][:, None], i_row)
            b = jnp.maximum(rep[0][:, None], i_row)
            return a * (2 * d - a + 1) // 2 + (b - a)

        q = K - 3  # head size of the merged multiset
        pas = self.pascal

        def tri(a, b, g):
            aa = a - g
            bb = b - g
            side = d - g
            return aa * (2 * side - aa + 1) // 2 + (bb - aa)

        # per-rep head colex terms (slots 1-based; s is 0-based)
        # P0[s] = C(j_s + s, s+1)  (j_s at slot s+1, unshifted)
        # S0[s] = C(j_s + s + 1, s+2)  (j_s shifted up one slot)
        if q > 0:
            P0 = jnp.stack(
                [pas[rep[s] + s, s + 1] for s in range(q)]
            )  # (q, seg)
            H0 = P0.sum(0)  # plain colex of head j_0..j_{q-1}
        else:
            H0 = jnp.zeros((seg,), jnp.int32)

        jq = rep[q]        # group element when i lands past the head
        jq1 = rep[q + 1]   # first tail element
        goff = self.group_off
        gT = self.group_T

        e_B = cnt == q
        e_C = cnt == q + 1
        e_D = cnt == q + 2
        jq_c = jq[:, None]
        jq1_c = jq1[:, None]
        pos = e_B * (
            goff[i_row[0]][None, :]
            + H0[:, None] * gT[i_row[0]][None, :]
            + tri(jq_c, jq1_c, i_row)
        )
        base_CD = goff[jq][:, None] + H0[:, None] * gT[jq][:, None]
        pos = pos + e_C * (base_CD + tri(i_row, jq1_c, jq_c))
        pos = pos + e_D * (base_CD + tri(jq1_c, i_row, jq_c))

        if q > 0:
            # case A: i inside the head (cnt ≤ q−1); head =
            # insert(j_0..j_{q−2}, i), group/tri = j_{q−1}, j_q, j_{q+1}
            S0 = jnp.stack(
                [pas[rep[s] + s + 1, s + 2] for s in range(q - 1)]
            ) if q > 1 else jnp.zeros((0, seg), jnp.int32)
            cumP = jnp.concatenate(
                [jnp.zeros((1, seg), jnp.int32), jnp.cumsum(P0, 0)]
            )  # cumP[t] = Σ_{s<t} P0[s], t = 0..q
            # cumS[t] = Σ_{s=t}^{q-2} S0[s]
            if q > 1:
                rev = jnp.cumsum(S0[::-1], 0)[::-1]
                cumS = jnp.concatenate(
                    [rev, jnp.zeros((1, seg), jnp.int32)]
                )  # (q, seg); cumS[q-1] = 0
            else:
                cumS = jnp.zeros((1, seg), jnp.int32)
            jm1 = rep[q - 1]
            baseA = goff[jm1][:, None]
            TA = gT[jm1][:, None]
            triA = tri(jq_c, jq1_c, jm1[:, None])
            # static C(i + t, t+1) rows
            CA = jnp.stack(
                [pas[i_row[0] + t, t + 1] for t in range(q)]
            )  # (q, d)
            hrank = jnp.zeros((seg, d), jnp.int32)
            for t in range(q):
                hrank = hrank + (cnt == t) * (
                    (cumP[t] + cumS[t])[:, None] + CA[t][None, :]
                )
            pos = pos + (cnt <= q - 1) * (baseA + hrank * TA + triA)
        return pos

    # ------------------------------------------------------------ big tables

    @property
    def rep(self) -> jnp.ndarray:
        """(n, rank) int32 — representative (ascending) multiset per packed
        position, in storage order."""

        def build():
            if self.rank == 0:
                return jnp.zeros((1, 0), dtype=jnp.int32)
            # reuse the host table (native-accelerated, memoized) instead of
            # re-enumerating
            return _i32(self.rep_np())

        return self._memo("rep", build)

    def rep_np(self) -> np.ndarray:
        """Host copy of `rep` (int64). Uses the native (C++) enumerator when
        available; NumPy fallback otherwise (bit-identical, tested)."""

        def build():
            _check_table(self.n * max(self.rank, 1), "rep_indices")
            if self.rank == 0:
                return np.zeros((1, 0), dtype=np.int64)
            if self.rank == 1:
                return np.arange(self.dim, dtype=np.int64)[:, None]
            from .. import native

            rep = native.gflat_rep(self.rank, self.dim)
            if rep is not None:
                return rep.astype(np.int64)
            return self.layout.rep_indices()

        return self._memo("rep_np", build)

    def _row_stats(self):
        """(γ float32, class-id int64) per position — one native pass when
        available."""

        def build():
            if self.rank == 0:
                return (
                    np.ones(1, dtype=np.float32),
                    np.zeros(1, dtype=np.int64),
                )
            from .. import native

            got = native.row_stats(
                self.rep_np(), self.rank, comb.perm_classes(self.rank)
            )
            if got is not None:
                gamma, cid = got
                return gamma, cid.astype(np.int64)
            rep = self.rep_np()
            return (
                comb.row_multiplicities(rep).astype(np.float32),
                comb.class_id_of_rows(rep, self.rank),
            )

        return self._memo("row_stats", build)

    @property
    def multiplicity(self) -> jnp.ndarray:
        """(n,) float32 — γ per packed position (r!/∏counts!)."""
        return self._memo(
            "multiplicity", lambda: jnp.asarray(self._row_stats()[0])
        )

    @property
    def class_ids_np(self) -> np.ndarray:
        """(n,) host int64 — σ-class id (index into perm_classes) per position."""
        return self._row_stats()[1]

    def class_positions_np(self, class_counts: comb.SigmaClass) -> np.ndarray:
        """Host int64 positions (in storage order) of one σ-class."""
        cid = self.perm_classes.index(tuple(class_counts))
        key = ("class_pos", cid)
        return self._memo(
            key, lambda: np.nonzero(self.class_ids_np == cid)[0]
        )

    def class_positions(self, class_counts: comb.SigmaClass) -> jnp.ndarray:
        cid = self.perm_classes.index(tuple(class_counts))
        return self._memo(
            ("class_pos_dev", cid),
            lambda: _i32(self.class_positions_np(class_counts)),
        )

    def class_rep(self, class_counts: comb.SigmaClass) -> jnp.ndarray:
        """(s_σ, rank) int32 device — representative indices of one σ-class
        in storage order (the gather map of per-class contractions)."""
        cid = self.perm_classes.index(tuple(class_counts))

        def build():
            pos = self.class_positions_np(class_counts)
            _check_table(len(pos) * max(self.rank, 1), "class_rep")
            return _i32(self.rep_np()[pos])

        return self._memo(("class_rep", cid), build)

    @property
    def dense_gather(self) -> jnp.ndarray:
        """(dim**rank,) int32 — packed position of sort(I) for every dense
        index I in C-order. todense() is a single gather through this."""

        def build():
            dn = self.dim**self.rank
            if dn > config.max_dense_elements:
                raise MemoryError(
                    f"dense size {dn:,} exceeds config.max_dense_elements"
                )
            _check_table(dn, "dense_gather")
            if self.rank == 0:
                return jnp.zeros((1,), dtype=jnp.int32)
            from .. import native

            pos = native.dense_gather(self.rank, self.dim)
            if pos is not None:
                return jnp.asarray(pos)
            # Build on host: all dense indices, sorted rows → positions.
            shape = (self.dim,) * self.rank
            grids = np.indices(shape).reshape(self.rank, -1).T  # (d^r, r)
            grids.sort(axis=1)
            if self.rank == 1:
                pos = grids[:, 0]
            else:
                pos = self.layout.position_array(grids)
            return _i32(pos)

        return self._memo("dense_gather", build)

    # ----------------------------------------------- monomial recursion data

    def mono_tables(self, size: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(parent, maxel) int32 device tables for building the colex
        monomial vector of multisets of `size` over {0..dim-1}."""

        def build():
            par, mx = comb.mono_recursion_tables(self.dim, size)
            _check_table(len(par), f"mono_tables({size})")
            return (_i32(par), _i32(mx))

        return self._memo(("mono", size), build)

    def mono_tables_weighted(
        self, size: int
    ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        """(parent, maxel, runlen) for the *EGF-weighted* monomial recursion

            W_k[p] = W_{k-1}[parent[p]] * x[maxel[p]] / runlen[p]

        yielding W_k[multiset m] = ∏_v x_v^{c_v} / c_v!  — the exponential-
        generating-function weight. Multiplying by k! recovers γ·monomial,
        which is exactly the summand of full-vector contraction
        (Σ_I-tuples A ∏x = Σ_multisets γ A ∏x = r! Σ W·A).

        runlen is static: the run length of the max element of each multiset,
        built level-by-level on the host.
        """

        def build():
            pars, mxs, runs = [], [], []
            prev_mx = np.zeros(1, dtype=np.int64)  # level 0: empty multiset
            prev_run = np.zeros(1, dtype=np.int64)
            for k in range(1, size + 1):
                par, mx = comb.mono_recursion_tables(self.dim, k)
                run = np.where(prev_mx[par] == mx, prev_run[par] + 1, 1)
                pars.append(par)
                mxs.append(mx)
                runs.append(run)
                prev_mx, prev_run = mx, run
            _check_table(sum(len(p) for p in pars), f"mono_weighted({size})")
            return tuple(
                (_i32(p), _i32(m), jnp.asarray(r.astype(np.float32)))
                for p, m, r in zip(pars, mxs, runs)
            )

        return self._memo(("mono_weighted", size), build)

    @property
    def colex_perm(self) -> jnp.ndarray:
        """(n,) int32 — colex rank of the multiset at each gflat position.
        Reorders colex-enumerated vectors (monomial recursions, basis-change
        outputs) into storage order: storage_vec = colex_vec[colex_perm]."""

        def build():
            if self.rank <= 1:
                return _i32(np.arange(max(self.n, 1), dtype=np.int64))
            return _i32(comb.colex_rank_array(self.rep_np()))

        return self._memo("colex_perm", build)

    def insert_table_np(self, k: int) -> np.ndarray:
        """Host-side `insert_table` (int32 NumPy) — memoized.  Used by the
        basis-change column windowing to upload per-window slices instead
        of slicing a large resident device table."""

        def build():
            tk = tables(k, self.dim)
            _check_table(tk.n * self.dim * (k + 1), f"insert_table({k})")
            rep = tk.rep_np()  # (N_k, k)
            d = self.dim
            if k >= 1:
                from .. import native

                nat = native.insert_table(rep, k, d)
                if nat is not None:
                    return np.asarray(nat, dtype=np.int32)
            out = np.empty((tk.n, d), dtype=np.int64)
            tk1 = tables(k + 1, self.dim)
            cols = np.empty((tk.n, k + 1), dtype=np.int64)
            for i in range(d):
                cols[:, :k] = rep
                cols[:, k] = i
                srt = np.sort(cols, axis=1)
                if k + 1 == 1:
                    out[:, i] = srt[:, 0]
                else:
                    out[:, i] = tk1.layout.position_array(srt)
            return out.astype(np.int32)

        return self._memo(("insert_np", k), build)

    def insert_table(self, k: int) -> jnp.ndarray:
        """(N_k, dim) int32 — position in the rank-(k+1) layout of
        sort(J ∪ {i}) for every size-k multiset J (storage order) and every
        value i. The gather map of single-index contraction steps."""
        return self._memo(("insert", k), lambda: _i32(self.insert_table_np(k)))

    @property
    def tri_pairs(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """(a_idx, b_idx) int32 of the full d-triangle in row-major order —
        the triangle monomial vector is x[a_idx] * x[b_idx]."""

        def build():
            d = self.dim
            a = np.concatenate([np.full(d - i, i, np.int64) for i in range(d)])
            b = np.concatenate([np.arange(i, d, dtype=np.int64) for i in range(d)])
            return (_i32(a), _i32(b))

        return self._memo("tri_pairs", build)


@lru_cache(maxsize=None)
def tables(rank: int, dim: int) -> Tables:
    if rank < 0 or dim < 1:
        raise ValueError(f"invalid (rank, dim) = ({rank}, {dim})")
    return Tables(rank, dim)
