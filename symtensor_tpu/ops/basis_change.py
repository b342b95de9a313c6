"""Blocked output-major basis change  C = A · W ⊗ … ⊗ W  on packed storage.

Reference semantics: symalg.contract_all_indices_with_matrix
(/root/reference/symtensor/symalg.py:475-496, generic = densify + einsum);
the compressed-domain algorithm family is Schatz-style one-index-at-a-time
contraction (graveyard sketch at
/root/reference/module_purgatory/torch_symmetric_tensor.py:487-534).

Algorithm
---------
Output multisets β (sorted ascending) are built level by level, appending
their max element b.  The level-t state rows are partial contractions

    U_t[β₁…β_t, α] = Σ_{i₁…i_t} A[{i₁…i_t} ∪ α] · W[i₁,β₁] ⋯ W[i_t,β_t]

over all size-(r−t) original multisets α (gflat storage order).  One step:

    U_{t+1}[(β, b), j] = Σ_i U_t[β, insert_k(j, i)] · W[i, b]     (k = r−t−1)

which is exact with no multiplicity bookkeeping because the slots are
contracted in order and A is symmetric; evaluating at sorted β gives every
independent component of the (automatically symmetric) result.

The round-1 implementation materialized each full level
(P_t × N_{r−t} — ~118 GB at rank-6 dim-100).  This version never does:
blocks of at most R_t rows per level are produced depth-first, children are
computed from the resident parent block by a fused gather→einsum→select
kernel, and finished leaf values are scattered straight into the output
buffer.  Peak memory = Σ_t R_t·N_{r−t} (the configured budget) + one
transient segment.  Colex bookkeeping (which rows exist, their max elements,
their representative multisets) is pure host-side NumPy; each level runs one
fixed-shape jitted kernel, so the whole flagship size compiles ~r programs.

Key structural facts used:
- children of a row with max m are (row, b) for every b ≥ m;
- within a block whose rows are sorted by max element, the parents of the
  children with new element b are a *prefix* of the block;
- the storage position of a finished leaf comes from its representative
  multiset via the closed-form gflat ranking (no inverse permutation).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import config
from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.tables import tables


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _fence_every() -> int:
    return _env_int("SYMTENSOR_BASIS_FENCE_EVERY", 4)


class _InflightThrottle:
    """Bound the bytes of asynchronously dispatched, not-yet-fenced work.

    Dispatch is asynchronous: the host can run far ahead of the device,
    and every queued program holds its output buffer.  Fences exist only
    to keep queued buffers from exhausting device memory, so this
    throttle counts the estimated bytes each dispatch allocates (outputs
    + uploads + declared gather/product workspaces) and fences only when
    the running total passes ``SYMTENSOR_BASIS_INFLIGHT_BYTES`` (default
    1.5 GB).  The device stream is in order, so one readback on the most
    recent output drains everything dispatched before it.  The budget was
    sized for a 16 GB device and has not been re-decided for the GPU.

    Attribution compatibility: when ``SYMTENSOR_BASIS_FENCE_EVERY`` is
    set explicitly, the throttle drains every Nth ``add`` instead, so
    fenced debugging runs keep accurate per-dispatch timestamps."""

    __slots__ = ("budget", "every", "pending", "adds", "last", "fences")

    def __init__(self):
        # backlog rides on top of the live blocks, root and output, so
        # the budget is part of the caller's memory margin
        self.budget = _env_int(
            "SYMTENSOR_BASIS_INFLIGHT_BYTES", 1_500_000_000
        )
        self.every = (
            _fence_every()
            if "SYMTENSOR_BASIS_FENCE_EVERY" in os.environ
            else 0
        )
        self.pending = 0
        self.adds = 0
        self.last = None
        self.fences = 0

    def add(self, nbytes, out=None, transient=0) -> bool:
        """Record a dispatch allocating ~nbytes that stay live until
        consumed (outputs, uploads).  `transient` (program workspace,
        freed when the program finishes; executions are serial so
        transients never stack) is accepted for the record but does NOT
        gate the drain: counting it forced near-per-chunk fences for
        kernels whose one-segment workspace alone approaches the budget
        (rank-5: 29 fences where 12 suffice).  The caller's memory margin
        must instead reserve budget + max-transient (~1.6 GB at the
        default segment cap).  Fences when pending exceeds the budget;
        returns True when a drain actually happened."""
        self.pending += int(nbytes)
        self.adds += 1
        if out is not None and not isinstance(out, jax.core.Tracer):
            self.last = out
        if self.every:
            if self.adds % self.every == 0:
                return self.drain()
            return False
        if self.pending >= self.budget:
            return self.drain()
        return False

    def drain(self) -> bool:
        arr = self.last
        self.pending = 0
        self.last = None
        if arr is None:
            return False
        float(arr[(0,) * arr.ndim])  # scalar readback drains the queue
        self.fences += 1
        return True


_LAST_THROTTLE: "_InflightThrottle | None" = None


# ---------------------------------------------------------------------------
# Device kernels — one compile per (level shape), cached
# ---------------------------------------------------------------------------


def _dot_operand_dtype(store_dt, acc_dt):
    """Operand dtype of the level GEMMs: bf16 blocks enter the dot as bf16
    with f32 accumulation (casting them to f32 at HIGHEST buys nothing on
    already-bf16 data); f32 blocks stay f32.  XLA:CPU's dot rejects
    BF16×BF16→F32, so on the CPU backend bf16 blocks are upcast."""
    if jnp.dtype(store_dt) == jnp.bfloat16 and jax.default_backend() != "cpu":
        return jnp.dtype(jnp.bfloat16)
    return jnp.dtype(acc_dt)


def _expand_groups(bs, starts, counts, nsel_pad):
    """Expand per-b group descriptors into per-slot (parent row, b, valid).

    Children of a chunk are runs of consecutive parent rows, one run per
    new max element b; `bs`/`starts`/`counts` are (nb_pad,) int32 group
    descriptors (padded groups have count 0).  Expanding them IN-KERNEL
    replaces the (nsel_pad,)-sized selector uploads: two 67 MB selector
    vectors plus a position vector per leaf chunk (~200 MB of host→device
    traffic) become a few KB of descriptors.
    """
    cum = jnp.cumsum(counts)
    s = jnp.arange(nsel_pad, dtype=jnp.int32)
    gid = jnp.searchsorted(cum, s, side="right").astype(jnp.int32)
    gid = jnp.minimum(gid, counts.shape[0] - 1)
    prev = (cum[gid] - counts[gid]).astype(jnp.int32)
    par = starts[gid] + (s - prev)
    return par, bs[gid], s < cum[-1]


def _bucket(nsel: int) -> int:
    """Round a leaf chunk's row count up to a power-of-4 bucket: the emit
    kernel's internal work is nsel_pad-sized, and padding every chunk to
    the full row budget made EVERY emit cost the worst case whether nsel
    was 8.5k or 15.5M."""
    b = 4096
    while b < nsel:
        b *= 4
    return b


@lru_cache(maxsize=None)
def _emit_kernel2(r, d_out, n_out, nsel_pad, store_dt):
    """Leaf emit with positions computed ON DEVICE from the parent
    block's representative table (uploaded once per block) — no per-emit
    position upload.

    reps_flat is COLUMN-major ((r−1) planes of npar): per-slot rep
    components come from (r−1) one-element fancy gathers instead of
    slice_sizes=(r−1,) row gathers of tiny slices."""
    t_out = tables(r, d_out)

    def kern(out, vals, reps_flat, bs, starts, counts):
        par, b, valid = _expand_groups(bs, starts, counts, nsel_pad)
        nrows = reps_flat.shape[0] // (r - 1)
        par = jnp.minimum(par, nrows - 1)
        cols = [
            reps_flat[j * nrows + par].astype(jnp.int32)[None, :]
            for j in range(r - 1)
        ]
        rep_T = jnp.concatenate(
            cols + [b[None, :].astype(jnp.int32)], axis=0
        )
        pos = t_out.position_jnp_T(rep_T)
        # padded slots land on DISTINCT dump positions past n_out so every
        # index is unique — with duplicates (all pads → one slot) XLA must
        # use its collision-safe scatter
        s = jnp.arange(nsel_pad, dtype=jnp.int32)
        pos = jnp.where(valid, pos, n_out + (s % _DUMP_SLOTS))
        return out.at[pos].set(
            vals[:nsel_pad].astype(out.dtype), unique_indices=False
        )

    return jax.jit(kern, donate_argnums=(0,))


# dump slots appended to the output buffer for padded emit rows; emits are
# bucketed so pad < nsel ≤ bucket, and pads beyond this wrap (collisions
# among pads are harmless — the slots are discarded)
_DUMP_SLOTS = 4096


@lru_cache(maxsize=None)
def _emit_kernel2_sharded(r, d_out, n_out, nsel_pad, store_dt, mesh,
                          axis, base):
    """Leaf emit into a tp-SHARDED output buffer.

    The single-device emit scatters into the whole packed output, which
    under a mesh left C replicated on every device (PartitionSpec() on the
    result) — breaking the memory scaling of the sharded mode (n devices
    hold A/n + C/n).  Here the output
    lives as ndev shards of `base` data slots + _DUMP_SLOTS dump slots
    each; positions and values are computed replicated (cheap — one
    leaf chunk at a time), and each device scatters only the positions
    it owns (pos // base == its index), dumping the rest locally.
    Per-device output residency: n_out/ndev + dump."""
    from jax.sharding import PartitionSpec

    t_out = tables(r, d_out)

    def kern(out, vals, reps_flat, bs, starts, counts):
        par, b, valid = _expand_groups(bs, starts, counts, nsel_pad)
        nrows = reps_flat.shape[0] // (r - 1)
        par = jnp.minimum(par, nrows - 1)
        cols = [
            reps_flat[j * nrows + par].astype(jnp.int32)[None, :]
            for j in range(r - 1)
        ]
        rep_T = jnp.concatenate(
            cols + [b[None, :].astype(jnp.int32)], axis=0
        )
        pos = t_out.position_jnp_T(rep_T)
        s = jnp.arange(nsel_pad, dtype=jnp.int32)
        v = vals[:nsel_pad].astype(out.dtype)

        def body(out_sh, pos_a, valid_a, v_a):
            me = jax.lax.axis_index(axis)
            dev = pos_a // base
            loc = pos_a % base
            m = valid_a & (dev == me)
            locpos = jnp.where(m, loc, base + (s % _DUMP_SLOTS))
            return out_sh.at[0, locpos].set(v_a, unique_indices=False)

        out2 = out.reshape(mesh.shape[axis], base + _DUMP_SLOTS)
        res = jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(
                PartitionSpec(axis, None),
                PartitionSpec(),
                PartitionSpec(),
                PartitionSpec(),
            ),
            out_specs=PartitionSpec(axis, None),
        )(out2, pos, valid, v)
        return res.reshape(-1)

    return jax.jit(kern, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _fused_leaf_emit(r, d, d_out, n_out, npar, w_pad, store_dt, acc_dt,
                     npar_eff=None):
    """Fused k = 0 step + leaf emit: one GEMM, per-PARENT base positions,
    one scatter.

    Children of a leaf parent occupy CONSECUTIVE gflat slots: for b ≥
    max(rep), pos(sort(rep ∪ {b})) = base(rep) + b (the tri row is
    contiguous in its last element), so the whole (npar, wp) product grid
    scatters with positions base[par] + b — no per-slot select, no
    per-slot rep gathers, no Pascal-table gathers (closed-form head
    ranks, tables.position_base_jnp_T).  The unfused pipeline paid ~4-5
    nsel-sized element-rate passes (select + rep gathers + ranking) per
    chunk.

    `npar_eff` (pow-2-bucketed, ≤ npar) restricts the product grid to the
    valid parent PREFIX of the chunk (parents are sorted by max element,
    so parents beyond counts[b_hi−1] have no children in this b-window).
    Without it every chunk GEMM-read the WHOLE block and scattered the
    full padded grid — at rank-5 dim-100 the 10 leaf chunks scattered
    1.31e9 slots for 9.2e7 useful ones and re-read the 1.77 GB level-4
    block 10× (counted by benchmarks/schedule_sim.py)."""
    t_out = tables(r, d_out)
    if npar_eff is None:
        npar_eff = npar
    mxu_dt = _dot_operand_dtype(store_dt, acc_dt)
    prec = None if mxu_dt == jnp.bfloat16 else jax.lax.Precision.HIGHEST

    def kern(out, rows_flat, Wm, b_lo, starts, counts, reps_flat):
        Wc = jax.lax.dynamic_slice(
            Wm, (jnp.int32(0), b_lo), (Wm.shape[0], w_pad)
        ).astype(mxu_dt)
        rows2 = rows_flat.reshape(npar, d)[:npar_eff]
        H = jax.lax.dot_general(
            rows2.astype(mxu_dt), Wc,
            (((1,), (0,)), ((), ())),
            preferred_element_type=acc_dt,
            precision=prec,
        )  # (npar_eff, w_pad)
        # reps arrive column-major flat ((r−1) planes of npar) — the
        # all-rows reshape is free (the unfused emit had to GATHER per
        # selected slot)
        rep = reps_flat.reshape(r - 1, npar)[:, :npar_eff].astype(jnp.int32)
        base = t_out.position_base_jnp_T(rep)  # (npar_eff,)
        par = jnp.arange(npar_eff, dtype=jnp.int32)[:, None]
        j = jnp.arange(w_pad, dtype=jnp.int32)[None, :]
        valid = (par >= starts[None, :]) & (
            par < (starts + counts)[None, :]
        )
        pos = base[:, None] + (b_lo + j)  # (npar_eff, w_pad)
        s = jnp.arange(npar_eff * w_pad, dtype=jnp.int32)
        posf = jnp.where(
            valid.reshape(-1), pos.reshape(-1), n_out + s % _DUMP_SLOTS
        )
        return out.at[posf].set(
            H.reshape(-1).astype(out.dtype), unique_indices=False
        )

    return jax.jit(kern, donate_argnums=(0,))


@lru_cache(maxsize=None)
def _combine_windows(nsel_pad, nkws, store_dt):
    """Reassemble column-windowed step outputs into one npar-major flat
    child block via a single concat.  Superseded in production by
    `_dus_combine` (donated in-place assembly, no n-operand transient);
    kept for the window-path probes."""

    def comb_fn(*outs):
        return jnp.concatenate(
            [o.reshape(nsel_pad, -1) for o in outs], axis=1
        ).reshape(-1)

    return jax.jit(comb_fn)


@lru_cache(maxsize=None)
def _dus_combine(nsel_pad, n_k, nkw, store_dt):
    """Write one column window (nsel_pad, nkw) into the flat npar-major
    child buffer in place (donated) at column offset c0."""
    import functools

    @functools.partial(jax.jit, donate_argnums=(0,))
    def put(buf_flat, piece, c0):
        b2 = buf_flat.reshape(nsel_pad, n_k)
        b2 = jax.lax.dynamic_update_slice(
            b2, piece.reshape(nsel_pad, nkw), (jnp.int32(0), c0)
        )
        return b2.reshape(-1)

    return put


@lru_cache(maxsize=None)
def _step_kernel(npar, piece_lens, n_k, d, k, w_pad, nsel_pad, seg,
                 store_dt, acc_dt, onthefly, mesh_axis=None):
    """(parent rows, W columns [b_lo, b_lo+w_pad)) → selected children,
    flattened (n_k·nsel_pad,).  Blocks travel as 1-D buffers so the root
    can be the tensor's own packed leaf with no reshape copy (a 2-D eager
    reshape of the 3.2 GB flagship leaf doubled residency); the 2-D views
    exist only inside the jit, where reshapes are free.  `seg` tiles the
    n_k axis so the gather transient stays bounded.  With `onthefly` the
    insert positions are computed from the level-k representative table by
    the closed-form gflat ranking instead of a materialized (n_k, d)
    gather map (which would be 9.2e9 int32 at rank-6 dim-100).

    Layout: blocks are stored npar-MAJOR flat, viewed (npar, width)
    row-major in-kernel (reshapes are free inside jit).  Parent access is
    the 2-D axis-1 shared-index gather `rows[:, idx]`: one index vector
    amortized over all npar rows, instead of per-column row gathers of
    tiny slices or a fancy index per element.  The (npar, width) view
    only exists inside the kernel; the stored buffer stays 1-D, so no
    tiled device layout pads a small npar axis.

    Child selection uses the SAME form: the product grid is staged
    transposed as Ht (n_k_window, npar·wp) — sub-tiled gather→GEMM→
    transpose passes — and the (par, b) children come out as ONE
    shared-index axis-1 gather Ht[:, par·wp + b], amortized over all
    n_k rows, in place of a per-segment element-gather select."""
    t_kp1 = tables(k + 1, d)
    # seg is sized from the FULL level's n_k by the caller; a column
    # window narrower than one segment (e.g. a width-1 last window) must
    # clamp, or the n_k == 1 branch below mis-shapes its gather
    seg = min(seg, n_k)
    mxu_dt = _dot_operand_dtype(store_dt, acc_dt)
    prec = (
        None if mxu_dt == jnp.bfloat16 else jax.lax.Precision.HIGHEST
    )
    if mesh_axis is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        mesh, axis = mesh_axis
        col_sharded = NamedSharding(mesh, PartitionSpec(axis))
        repl = NamedSharding(mesh, PartitionSpec())
    # The t = 0 root step keeps the ROOT SHARDED over the mesh axis: each
    # device masked-gathers only the insert positions resident in its
    # shard, runs its partial GEMM, and the children psum across devices.
    # This is what makes the "A/n_dev per device" residency of the sharded mode
    # real — the previous revision replicated the root (a full-size
    # all-gather per window, defeating the memory scaling of the sharded
    # mode).  Deep steps (npar > 1) still
    # all-gather their (budget-bounded) parent block, as documented.
    shard_root = (
        mesh_axis is not None
        and npar == 1
        and len(piece_lens) == 1
        and piece_lens[0] % mesh_axis[0].shape[mesh_axis[1]] == 0
    )

    nseg = -(-n_k // seg)
    n_k_pad = nseg * seg

    width_par = sum(piece_lens) // npar
    multi = len(piece_lens) > 1  # root leaf split into gather pieces
    # (SYMTENSOR_GATHER_MAX_BYTES; see basis_change_packed)

    def kern(rows_pieces, tbl_or_rep, Wm, b_lo, bs, starts, counts):
        # per-slot selectors expanded in-kernel from tiny group
        # descriptors (see _expand_groups)
        sel_par, sel_b_abs, _ = _expand_groups(bs, starts, counts, nsel_pad)
        sel_par = jnp.minimum(sel_par, npar - 1)
        sel_b = jnp.clip(sel_b_abs - b_lo, 0, w_pad - 1)
        if not multi:
            rows_flat = rows_pieces[0]  # 1-D, (width_par·npar,) row-major
            if mesh_axis is not None and not shard_root:
                # parents replicated (one all-gather per block when the
                # caller hands in a sharded previous level); children
                # sharded — each device computes its slice locally.
                rows_flat = jax.lax.with_sharding_constraint(rows_flat, repl)
        Wc = jax.lax.dynamic_slice(
            Wm, (0, b_lo), (Wm.shape[0], w_pad)
        )
        pad = n_k_pad - n_k
        tbl = tbl_or_rep
        if onthefly:
            # rep table arrives FLAT 1-D (row-major (n_k, k) flattened):
            # no stored array has a tiny minor dimension
            if pad:
                tbl = jnp.concatenate(
                    [tbl, jnp.zeros((pad * k,), tbl.dtype)]
                )
            tbl = tbl.reshape(nseg, seg * k)
        else:
            if pad:
                tbl = jnp.concatenate(
                    [tbl, jnp.broadcast_to(tbl[:1], (pad,) + tbl.shape[1:])]
                )
            tbl = tbl.reshape((nseg, seg) + tbl.shape[1:])

        def _ranked(tseg):
            if onthefly:
                # closed-form INSERT ranking: per-rep prefix sums + masked
                # multiply-add planes (tables.position_insert_jnp_T) —
                # no (k+1, seg, d) sort stack, no per-element Pascal
                # gathers
                rep_T = tseg.reshape(seg, k).astype(jnp.int32).T  # (k, seg)
                return t_kp1.position_insert_jnp_T(rep_T)  # (seg, d)
            return tseg  # (seg, d)

        if multi or npar == 1:
            # root-ish cases: one parent row (or a split root) — the
            # element-gather floor is intrinsic here; production routes
            # rank ≥ 4 roots to ops/basis_root.py instead
            def seg_body(tseg):
                sl = _ranked(tseg)
                if shard_root:
                    # root sharded over the mesh axis: per-device masked
                    # gather of the locally resident positions, partial
                    # GEMM, psum of the (seg, wp) children — communication
                    # is output-sized (n_k·wp per window), never
                    # root-sized, and no device ever holds the full root.
                    # A local shard larger than the gather-operand limit
                    # (SYMTENSOR_GATHER_MAX_BYTES) is gathered in masked
                    # PIECES, as on the single-device split-root path.
                    def shard_body(rows_shard, sl_a, Wc_a):
                        L = rows_shard.shape[0]
                        off = jax.lax.axis_index(axis) * L
                        loc = sl_a - off
                        gmax = _env_int(
                            "SYMTENSOR_GATHER_MAX_BYTES",
                            (1 << 31) - (1 << 27),
                        )
                        npc = max(
                            1, -(-L * jnp.dtype(store_dt).itemsize // gmax)
                        )
                        Lp = -(-L // npc)
                        Gp = jnp.zeros(sl_a.shape, mxu_dt)
                        for p in range(npc):
                            p0 = p * Lp
                            p1 = min(p0 + Lp, L)
                            piece = jax.lax.slice(rows_shard, (p0,), (p1,))
                            lp = loc - p0
                            mp = (lp >= 0) & (lp < p1 - p0)
                            Gp = Gp + jnp.where(
                                mp,
                                piece[
                                    jnp.clip(lp, 0, p1 - p0 - 1)
                                ].astype(mxu_dt),
                                jnp.zeros((), mxu_dt),
                            )
                        Gp = Gp[None, :, :]
                        Hp = jax.lax.dot_general(
                            Gp, Wc_a,
                            (((2,), (0,)), ((), ())),
                            preferred_element_type=acc_dt,
                            precision=prec,
                        )
                        return jax.lax.psum(Hp, axis)

                    H = jax.shard_map(
                        shard_body,
                        mesh=mesh,
                        in_specs=(
                            PartitionSpec(axis),
                            PartitionSpec(),
                            PartitionSpec(),
                        ),
                        out_specs=PartitionSpec(),
                    )(rows_flat, sl, Wc.astype(mxu_dt))
                    Hf = H.reshape(seg * w_pad)
                    sel = Hf[
                        jnp.arange(seg, dtype=jnp.int32)[:, None] * w_pad
                        + sel_b[None, :]
                    ]
                    if n_k == 1:
                        return sel.reshape(-1).astype(store_dt)
                    return sel.astype(store_dt)
                if not multi:
                    # single piece, npar == 1 (the unsplit root): PLAIN
                    # element gather — positions are in-bounds by
                    # construction, and the masked clip/where/compare form
                    # costs several extra passes over (seg, d)
                    G = rows_flat[sl].astype(mxu_dt)[None, :, :]
                else:
                    # masked multi-piece gather (split oversized root)
                    acc = jnp.zeros(sl.shape, mxu_dt)
                    off = 0
                    for piece in rows_pieces:
                        L = piece.shape[0]
                        loc = sl - off
                        m = (loc >= 0) & (loc < L)
                        acc = acc + jnp.where(
                            m,
                            piece[jnp.clip(loc, 0, L - 1)].astype(mxu_dt),
                            jnp.zeros((), mxu_dt),
                        )
                        off += L
                    G = acc[None, :, :]  # (1, seg, d)
                H = jax.lax.dot_general(
                    G, Wc.astype(mxu_dt),
                    (((2,), (0,)), ((), ())),
                    preferred_element_type=acc_dt,
                    precision=prec,
                )  # (1, seg, wp)
                Hf = H.reshape(seg * w_pad)
                sel = Hf[
                    jnp.arange(seg, dtype=jnp.int32)[:, None] * w_pad
                    + sel_b[None, :]
                ]  # (seg, nsel_pad)
                if n_k == 1:
                    return sel.reshape(-1).astype(store_dt)
                return sel.astype(store_dt)

            if n_k == 1:
                out = (
                    seg_body(tbl[0]) if nseg == 1
                    else jax.lax.map(seg_body, tbl).reshape(-1)
                )[:nsel_pad]
            elif nseg == 1:
                out = seg_body(tbl[0])[:n_k].T.reshape(-1)
            else:
                out = (
                    jax.lax.map(seg_body, tbl)
                    .reshape(n_k_pad, nsel_pad)[:n_k]
                    .T.reshape(-1)
                )
        elif n_k == 1:
            # single child column (the k = 0 leaf step): gather the d
            # parent columns, one GEMM, element-select the (par, b) pairs
            sl = _ranked(tbl[0])  # (1, d)
            rows2 = rows_flat.reshape(npar, width_par)
            G = (
                rows2[:, sl.reshape(-1)]
                .astype(mxu_dt)
                .reshape(npar, 1, d)
            )
            H = jax.lax.dot_general(
                G, Wc.astype(mxu_dt),
                (((2,), (0,)), ((), ())),
                preferred_element_type=acc_dt,
                precision=prec,
            )  # (npar, 1, wp)
            Hf = H.reshape(npar * w_pad)
            out = Hf[sel_par * w_pad + sel_b].astype(store_dt)
        else:
            # fast path: sub-tiled gather→GEMM→transpose staging, then
            # ONE shared-index axis-1 select over all n_k rows.
            # - parent gather rows2[:, idx] amortizes the index over the
            #   npar rows;
            # - the (par, b) child select Ht[:, par·wp + b] amortizes its
            #   index over the n_k rows, in place of a per-segment
            #   element-gather select.
            # Ht = (n_k, npar·wp) in store dtype; the caller windows n_k
            # so Ht stays under SYMTENSOR_BASIS_FAN_ELEMS.
            def sub_tile(tseg):
                sl = _ranked(tseg)
                rows2 = rows_flat.reshape(npar, width_par)
                G = (
                    rows2[:, sl.reshape(-1)]
                    .astype(mxu_dt)
                    .reshape(npar, seg, d)
                )
                H = jax.lax.dot_general(
                    G, Wc.astype(mxu_dt),
                    (((2,), (0,)), ((), ())),
                    preferred_element_type=acc_dt,
                    # f32 blocks use HIGHEST (a faster algorithm may
                    # round f32 operands); bf16 blocks run as bf16 (see
                    # _dot_operand_dtype)
                    precision=prec,
                )  # (npar, seg, wp)
                # store-dtype staging halves the transpose/select bytes;
                # no arithmetic follows the GEMM, so precision is
                # unchanged vs the old post-select cast
                return (
                    jnp.transpose(H, (1, 0, 2))
                    .reshape(seg, npar * w_pad)
                    .astype(store_dt)
                )

            if nseg == 1:
                Ht = sub_tile(tbl[0])  # (seg = n_k_pad, npar·wp)
            else:
                Ht = jax.lax.map(sub_tile, tbl).reshape(
                    n_k_pad, npar * w_pad
                )
            sel_cols = sel_par * w_pad + sel_b  # (nsel_pad,)
            sel = (Ht if n_k_pad == n_k else Ht[:n_k])[:, sel_cols]
            out = sel.T.reshape(-1)  # (nsel_pad · n_k,) npar-major
        if mesh_axis is not None and n_k > 1:
            out = jax.lax.with_sharding_constraint(out, col_sharded)
        return out

    return jax.jit(kern)


# ---------------------------------------------------------------------------
# Host-side blocks and schedule
# ---------------------------------------------------------------------------


class _Block:
    """One resident block of level-t rows: device values (flattened
    (nrows_pad·width,)) + host bookkeeping (max element and representative
    multiset per row, sorted by max)."""

    __slots__ = ("U", "maxels", "reps", "nrows", "npar", "width",
                 "reps_dev")

    def __init__(self, U, maxels, reps, nrows, npar, width):
        self.U = U  # tuple of 1-D device pieces, total npar·width
        self.maxels = maxels  # (nrows,) np int64, ascending
        self.reps = reps  # (nrows, t) np int32, rows sorted ascending
        self.nrows = nrows
        self.npar = npar  # padded row count
        self.width = width
        self.reps_dev = None  # lazy flat device copy (leaf-parent blocks)


def _row_budgets(r, d_out, widths, total_elems):
    """Rows per level under the element budget.

    Waterfill: levels that fit ENTIRELY (R_t = N_t rows) are granted
    first — a full level means ONE chunk, and every extra chunk at level
    t re-pays the parent fan-out gather, so chunk COUNT drives the cost.
    Grant
    order is by level footprint (cheapest full levels first); leftover
    budget is split half to the shallowest unfull level (each of its
    chunks costs a full parent re-pass), rest evenly."""
    R = [None] + [0] * r
    caps = [None] + [comb.multiset_count(d_out, t) for t in range(1, r + 1)]
    # leaf rows are scatter-op sized, not memory-resident
    leaf_cap = min(caps[r], 2**24)
    remaining = total_elems
    full = set()
    order = sorted(range(1, r), key=lambda t: caps[t] * widths[t])
    for t in order:
        need = caps[t] * widths[t]
        if need <= remaining * 0.9:
            R[t] = caps[t]
            full.add(t)
            remaining -= need
    unfull = [t for t in range(1, r) if t not in full]
    for i, t in enumerate(sorted(unfull)):
        share = (
            remaining / 2 if i == 0 and len(unfull) > 1
            else remaining / 2 / max(1, len(unfull) - 1) if len(unfull) > 1
            else remaining
        )
        R[t] = int(min(caps[t], max(1, share // widths[t])))
    R[r] = leaf_cap
    return R


# ---------------------------------------------------------------------------
# small-size whole-op jitted route
# ---------------------------------------------------------------------------

_SMALL_JIT_CACHE: dict = {}


def _small_peak_elems(r: int, d: int, d_out: int, transient: int) -> int:
    """Projected peak element residency of the whole-op jitted route:
    parent level + child level (×2 for the segment concatenate) + one
    bounded gather transient."""
    peak = 0
    for t in range(r):
        P_t = comb.multiset_count(d_out, t)
        P_t1 = comb.multiset_count(d_out, t + 1)
        N_par = comb.indep_size(r - t, d)
        N_k = comb.indep_size(r - t - 1, d) if r - t - 1 >= 1 else 1
        peak = max(peak, P_t * N_par + 2 * P_t1 * N_k)
    return peak + transient


def _basis_change_small(r, d, d_out, store_dt, acc_dt, budget):
    """Whole-op jitted output-major basis change, size-gated: one XLA
    program with no per-chunk dispatch, taken where its full-level
    intermediates fit in memory.  Semantics: reference
    symalg.py:475-496."""
    t_in = tables(r, d)
    t_out = tables(r, d_out)

    def run(data, W):
        U = data.astype(acc_dt).reshape(1, -1)
        Wc = W.astype(acc_dt)
        for t in range(r):
            k = r - t - 1
            if k >= 1:
                tbl = t_in.insert_table(k)  # (N_k, d)
                N_k = int(tbl.shape[0])
            else:
                tbl = None
                N_k = 1
            par, mx = t_out.mono_tables(t + 1)  # colex level t+1 over d_out
            # parents needed per max value b = colex prefix of length m_b
            m = [comb.multiset_count(b + 1, t) for b in range(d_out)]
            off = [comb.multiset_count(b, t + 1) for b in range(d_out + 1)]

            # greedy b-chunks under the transient element budget
            chunks = []
            b0 = 0
            while b0 < d_out:
                b1 = b0 + 1
                while b1 < d_out and m[b1] * N_k * (b1 + 1 - b0) <= budget:
                    b1 += 1
                chunks.append((b0, b1))
                b0 = b1

            def extend(U_pref, width, Wslice):
                mm = U_pref.shape[0]
                if k < 1:
                    return jnp.einsum(
                        "pji,ib->pjb",
                        U_pref.reshape(mm, 1, d),
                        Wslice,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=acc_dt,
                    )
                CH = max(1, min(mm, budget // (N_k * d)))
                if CH >= mm:
                    return jnp.einsum(
                        "pji,ib->pjb",
                        U_pref[:, tbl],
                        Wslice,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=acc_dt,
                    )
                nch = -(-mm // CH)
                pad = nch * CH - mm
                U_pad = (
                    jnp.concatenate(
                        [U_pref,
                         jnp.zeros((pad, U_pref.shape[1]), U_pref.dtype)]
                    )
                    if pad
                    else U_pref
                )
                return jax.lax.map(
                    lambda u: jnp.einsum(
                        "pji,ib->pjb",
                        u[:, tbl],
                        Wslice,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=acc_dt,
                    ),
                    U_pad.reshape(nch, CH, -1),
                ).reshape(nch * CH, N_k, width)[:mm]

            segs = []
            for b0, b1 in chunks:
                mm = m[b1 - 1]
                H = extend(U[:mm], b1 - b0, Wc[:, b0:b1])
                o0, o1 = off[b0], off[b1]
                seg_par = par[o0:o1]
                seg_mx = mx[o0:o1] - b0
                segs.append(H[seg_par, :, seg_mx])  # (o1-o0, N_k)
            U = segs[0] if len(segs) == 1 else jnp.concatenate(segs, axis=0)

        # U: (P_r, 1) in colex order of output multisets → gflat order
        return U[:, 0][t_out.colex_perm].astype(store_dt)

    return jax.jit(run)


def basis_change_packed(
    A: FlatSymmetricTensor,
    W,
    *,
    block_elems: Optional[int] = None,
    transient_elems: Optional[int] = None,
    store_dtype=None,
    acc_dtype=None,
    onthefly_above: Optional[int] = None,
    donate_root: bool = False,
    mesh=None,
    tp_axis: str = "tp",
) -> FlatSymmetricTensor:
    """Blocked basis change of a packed symmetric tensor.

    block_elems: total element budget across resident level blocks
      (default $SYMTENSOR_BASIS_BLOCK_ELEMS or 2**27 ≈ 512 MB f32).
    transient_elems: per-kernel gather/einsum transient budget
      (default $SYMTENSOR_BASIS_TRANSIENT_ELEMS or 2**26).
    store_dtype: dtype of level blocks and output (default A.dtype —
      pass bfloat16 to halve residency at large sizes);
    acc_dtype: einsum accumulation dtype (default float32, or float64
      when the data is float64).
    donate_root: free A's device buffer as soon as the recursion no
      longer needs it — on the generic path, once the root has been
      split into gather pieces (only happens when A.data exceeds
      $SYMTENSOR_GATHER_MAX_BYTES, where the split is a full copy); on
      the case-decomposed root-kernel path (SYMTENSOR_BASIS_ROOT=1,
      default for rank ≥ 4), right after the per-group block split,
      before any root window runs.
      INVALIDATES the caller's tensor — at rank-6 dim-100 bf16 this
      returns 3.2 GB of device memory that the recursion otherwise cannot
      use.
    mesh/tp_axis: optional jax.sharding.Mesh — level blocks are sharded
      over their (wide) original-multiset column axis on `tp_axis`; the
      block budget then scales with the axis size.  Each step re-gathers
      the parent block once across devices (parents are read across all
      columns) and computes its column slice locally.
    """
    r, d = A.rank, A.dim
    W = jnp.asarray(W)
    if W.ndim != 2 or W.shape[0] != d:
        raise ValueError(
            f"W must be (dim, d_out) = ({d}, ·); got {W.shape} "
            "(reference symalg.py:481)"
        )
    d_out = int(W.shape[1])
    store_dt = jnp.dtype(store_dtype or A.dtype)
    if acc_dtype is None:
        acc_dtype = (
            jnp.float64 if A.dtype == jnp.float64 else jnp.float32
        )
    acc_dt = jnp.dtype(acc_dtype)
    if r == 0:
        return FlatSymmetricTensor._raw(0, 1, A.data.astype(store_dt))
    if r == 1:
        out = A.data.astype(acc_dt) @ W.astype(acc_dt)
        return FlatSymmetricTensor._raw(1, d_out, out.astype(store_dt))

    # Small/mid sizes: one whole-op XLA program beats the eager blocked
    # recursion by ~9× warm (no per-chunk dispatch, fused levels).  Taken
    # only on all-default invocations — explicit blocked-path tuning
    # (block/transient budgets, onthefly, donate, mesh) keeps the blocked
    # recursion, so tests and callers that select it get what they asked
    # for.  Gate on projected peak residency;
    # SYMTENSOR_BASIS_SMALL_ELEMS=0 disables.
    small_elems = _env_int("SYMTENSOR_BASIS_SMALL_ELEMS", 2**28)
    all_default = (
        block_elems is None
        and transient_elems is None
        and onthefly_above is None
        and not donate_root
        and mesh is None
        and "SYMTENSOR_BASIS_BLOCK_ELEMS" not in os.environ
        and "SYMTENSOR_BASIS_TRANSIENT_ELEMS" not in os.environ
    )
    small_budget = 2**26
    if (
        all_default
        and small_elems > 0
        and _small_peak_elems(r, d, d_out, small_budget) <= small_elems
    ):
        key = (r, d, d_out, str(store_dt), str(acc_dt), small_budget)
        fn = _SMALL_JIT_CACHE.get(key)
        if fn is None:
            fn = _SMALL_JIT_CACHE[key] = _basis_change_small(
                r, d, d_out, store_dt, acc_dt, small_budget
            )
        return FlatSymmetricTensor._raw(r, d_out, fn(A.data, W))

    block_elems = block_elems or _env_int(
        "SYMTENSOR_BASIS_BLOCK_ELEMS", 2**27
    )
    transient_elems = transient_elems or _env_int(
        "SYMTENSOR_BASIS_TRANSIENT_ELEMS", 2**26
    )

    widths = [comb.indep_size(r - t, d) for t in range(r + 1)]
    R = _row_budgets(r, d_out, widths, block_elems)
    # explicit per-level row overrides, e.g. SYMTENSOR_BASIS_ROWS=1:20,3:2000
    # (tuning knob: R[1] sets the root window width = number of full root
    # sweeps; raising it trades level-1 block residency for sweep count)
    for part in os.environ.get("SYMTENSOR_BASIS_ROWS", "").split(","):
        if ":" in part:
            lev, rows = part.split(":", 1)
            lev = int(lev)
            if 1 <= lev <= r:
                R[lev] = max(1, min(
                    int(rows), comb.multiset_count(d_out, lev)
                ))

    # per-level window widths: wide enough that chunks can fill their row
    # budget from the parent block's fan-out
    w_pad = [None] * (r + 1)
    prevR = 1
    for t in range(1, r + 1):
        w_pad[t] = int(min(d_out, max(4, -(-2 * R[t] // prevR))))
        prevR = R[t]

    layout_out = tables(r, d_out).layout
    n_out = comb.indep_size(r, d_out)
    if n_out >= 2**31 - 1:
        # device-side int32 position ranking (the emit kernel) caps the
        # output space; the pre-device-emit host int64 path was removed
        raise ValueError(
            f"output space C({d_out}+{r}-1, {r}) = {n_out:,} exceeds the "
            "int32 position range of the device-side emit; split W's "
            "columns into windows and concatenate the results"
        )
    # output buffer with wrap-around dump slots for padded emit rows; under
    # a mesh it lives SHARDED over tp as ndev shards of (base + dump)
    # slots each — per-device residency n_out/ndev, see
    # _emit_kernel2_sharded (the single-device layout left C replicated)
    if mesh is not None:
        from jax.sharding import NamedSharding as _NSo, PartitionSpec as _Po

        _ndev_out = mesh.shape[tp_axis]
        out_base = -(-n_out // _ndev_out)
        out_buf = jax.device_put(
            jnp.zeros(
                (_ndev_out * (out_base + _DUMP_SLOTS),), dtype=store_dt
            ),
            _NSo(mesh, _Po(tp_axis)),
        )
    else:
        out_base = None
        out_buf = jnp.zeros((n_out + _DUMP_SLOTS,), dtype=store_dt)

    # insert maps per k: materialized gather map when small, otherwise the
    # (n_k, k) representative table + closed-form ranking in-kernel
    _maps = {}

    fly_limit = (
        config.max_table_entries if onthefly_above is None else onthefly_above
    )

    def insert_map(k):
        if k not in _maps:
            n_k = comb.indep_size(k, d)
            if n_k * d <= fly_limit:
                _maps[k] = (tables(r, d).insert_table(k), False)
            else:
                # FLAT 1-D upload in the narrowest integer type that holds
                # the dimension (the k=5 flagship table is 460 MB as flat
                # int8, 1.8 GB as int32), with no tiny minor dimension
                rep_np = tables(k, d).rep_np()
                if d <= 127:
                    dt = np.int8
                elif d <= 32767:
                    dt = np.int16
                else:
                    dt = np.int32
                _maps[k] = (
                    jnp.asarray(rep_np.astype(dt).reshape(-1)),
                    True,
                )
        return _maps[k]

    _maps_host = {}
    _win_tbls = {}

    def insert_map_host(k, onthefly):
        """Host-side table for the column-windowed path: windows upload
        their own ~46 MB slices instead of slicing a large resident
        device table."""
        if k not in _maps_host:
            if onthefly:
                rep_np = tables(k, d).rep_np()
                if d <= 127:
                    dt = np.int8
                elif d <= 32767:
                    dt = np.int16
                else:
                    dt = np.int32
                _maps_host[k] = np.ascontiguousarray(
                    rep_np.astype(dt).reshape(-1)
                )
            else:
                _maps_host[k] = tables(r, d).insert_table_np(k)
        return _maps_host[k]

    # Zero-pad W's columns by the largest window so the in-kernel
    # dynamic_slice never clamps b_lo (clamping would silently shift the
    # selected columns when a window overhangs d_out).  The per-row case
    # path slices (d, row_w) windows, so the pad must cover those too.
    row_w_cap = int(
        min(d_out, _env_int("SYMTENSOR_BASIS_ROW_WINDOW", 50))
    )
    # adaptive per-chunk step-window cap (see process(): wide windows cut
    # parent re-sweeps)
    step_wcap = int(min(d_out, _env_int("SYMTENSOR_BASIS_STEP_WINDOW", 128)))
    wmax = max(w_pad[1:] + [row_w_cap, step_wcap])
    Wdev = jnp.concatenate(
        [W.astype(acc_dt), jnp.zeros((d, wmax), dtype=acc_dt)], axis=1
    )

    def _group_descriptors(groups, nb_pad):
        """Pad (b, start, count) triples to (nb_pad,) int32 device arrays —
        a ~KB upload replacing the (nsel_pad,) selector/position vectors
        (~200 MB per leaf chunk at flagship sizes)."""
        nb = len(groups)
        arr = np.zeros((3, nb_pad), np.int32)
        for i, (b, p0, c) in enumerate(groups):
            arr[0, i], arr[1, i], arr[2, i] = b, p0, c
        dev = jnp.asarray(arr)
        return dev[0], dev[1], dev[2]

    def ensure_reps_dev(blk):
        """One upload per leaf-parent block: COLUMN-major flat rep table
        the emit kernels rank into output positions (narrowest dtype)."""
        if blk.reps_dev is None:
            rdt = (
                np.int8 if d_out <= 127
                else np.int16 if d_out <= 32767 else np.int32
            )
            rp = np.zeros((blk.npar, r - 1), rdt)
            rp[: blk.nrows] = blk.reps
            blk.reps_dev = jnp.asarray(
                np.ascontiguousarray(rp.T).reshape(-1)
            )
            thr.add(rp.nbytes)

    def run_chunk(t, blk, kern, tbl_arg, b_lo, groups, nsel_pad, nb_pad,
                  ws_est=0):
        nonlocal out_buf
        stats["chunks"] += 1
        child_level = t + 1
        nsel = sum(c for _, _, c in groups)
        if kern is None:  # fused leaf (eligibility decided in process())
            # Fused k=0 step + emit: the group b-values are consecutive
            # from b_lo by construction (see the chunk loop), so column j
            # of the product grid is b_lo + j and validity is the
            # (starts, counts) parent range per column.
            #
            # STAIRCASE TILING: counts ascend with b, so one grid sized
            # by the LAST group's parent need scatters up to ~5× the
            # valid slots (schedule_sim at rank-6 dim-100: 7.69e9
            # scattered for 1.6e9 valid).
            # Split the window into runs of groups sharing a pow-2
            # parent-need bucket and dispatch one exact-height grid per
            # run — dispatches are cheap once the throttle (not a
            # cadence) decides the fences.
            ensure_reps_dev(blk)
            segs = []
            cur, cur_npe = [], None
            for g in groups:
                _b, p0, c = g
                npe_g = 4096
                while npe_g < p0 + c:
                    npe_g *= 2
                npe_g = min(npe_g, blk.npar)
                if cur and npe_g != cur_npe:
                    segs.append((cur_npe, cur))
                    cur = []
                cur_npe = npe_g
                cur.append(g)
            if cur:
                segs.append((cur_npe, cur))

            # Merge adjacent staircase segments whose split saves little:
            # every extra emit is one more dispatch, so a split must save
            # ≥ SYMTENSOR_BASIS_EMIT_SPLIT_MIN padded slots to pay for
            # itself.  Rank-5's staircase had split 10 emits into 52 to
            # save only 1.4e8 slots.
            def _slots(npe, ng):
                nbp = 4
                while nbp < ng:
                    nbp *= 2
                return npe * min(nbp, nb_pad)

            split_min = _env_int(
                "SYMTENSOR_BASIS_EMIT_SPLIT_MIN", 8_000_000
            )
            merged = [segs[0]]
            for npe, g in segs[1:]:
                pnpe, pg = merged[-1]
                extra = (
                    _slots(max(pnpe, npe), len(pg) + len(g))
                    - _slots(pnpe, len(pg))
                    - _slots(npe, len(g))
                )
                if extra <= split_min:
                    merged[-1] = (max(pnpe, npe), pg + g)
                else:
                    merged.append((npe, g))
            segs = merged
            for npe, seg_groups in segs:
                nbp = 4
                while nbp < len(seg_groups):
                    nbp *= 2
                nbp = min(nbp, nb_pad)
                sb_lo = seg_groups[0][0]
                bs_s, st_s, ct_s = _group_descriptors(seg_groups, nbp)
                out_buf = _fused_leaf_emit(
                    r, d, d_out, n_out, blk.npar, nbp,
                    str(store_dt), str(acc_dt), npe,
                )(out_buf, blk.U[0], Wdev, jnp.int32(sb_lo), st_s, ct_s,
                  blk.reps_dev)
                stats["emits"] = stats.get("emits", 0) + 1
                # out_buf is donated through; the dispatch allocates the
                # (npe, wp) f32 product grid + position/value staging
                fenced = thr.add(0, out_buf, transient=npe * nbp * 12)
                if verbose and fenced:
                    import sys
                    import time as _time

                    print(
                        f"[basis {_time.time()-stats['t0']:8.1f}s]   "
                        f"leaf emit #{stats['emits']} nsel={nsel} "
                        f"npar={blk.nrows} b_lo={sb_lo} (fused)",
                        file=sys.stderr,
                        flush=True,
                    )
            return
        bs_d, st_d, ct_d = _group_descriptors(groups, nb_pad)
        child_U = kern(
            blk.U, tbl_arg, Wdev, b_lo, bs_d, st_d, ct_d
        )  # flattened (nsel_pad · n_k_child,)
        thr.add(
            int(child_U.size) * child_U.dtype.itemsize, child_U,
            transient=ws_est,
        )
        if child_level == r:
            ensure_reps_dev(blk)
            bucket = min(_bucket(nsel), nsel_pad)
            if mesh is not None:
                ek = _emit_kernel2_sharded(
                    r, d_out, n_out, bucket, str(store_dt), mesh,
                    tp_axis, out_base,
                )
            else:
                ek = _emit_kernel2(r, d_out, n_out, bucket, str(store_dt))
            out_buf = ek(
                out_buf, child_U[:bucket], blk.reps_dev, bs_d, st_d, ct_d
            )
            # each queued unfused emit holds its bucket-sized child_U step
            # output alive plus position staging; the throttle bounds the
            # queue (observed OOM at flagship size without fencing)
            stats["emits"] = stats.get("emits", 0) + 1
            fenced = thr.add(bucket * 8, out_buf)
            if verbose and fenced:
                import sys
                import time as _time

                print(
                    f"[basis {_time.time()-stats['t0']:8.1f}s]   leaf emit "
                    f"#{stats['emits']} nsel={nsel} npar={blk.nrows} "
                    f"b_lo={b_lo}",
                    file=sys.stderr,
                    flush=True,
                )
            return
        # host bookkeeping for the child block (cheap; device never sees it)
        sel_par = np.concatenate(
            [np.arange(p0, p0 + c, dtype=np.int64) for _, p0, c in groups]
        )
        sel_b = np.concatenate(
            [np.full(c, b, dtype=np.int64) for b, _, c in groups]
        )
        child_reps = np.concatenate(
            [blk.reps[sel_par], sel_b[:, None].astype(np.int32)], axis=1
        )
        child = _Block(
            (child_U,), sel_b, child_reps, nsel,
            nsel_pad, comb.indep_size(r - child_level, d),
        )
        process(child_level, child)

    verbose = os.environ.get("SYMTENSOR_BASIS_VERBOSE", "") not in ("", "0")
    stats = {"chunks": 0, "t0": None}
    thr = _InflightThrottle()
    global _LAST_THROTTLE
    _LAST_THROTTLE = thr  # introspection (schedule_sim, tests)
    if verbose:
        import sys
        import time as _time

        stats["t0"] = _time.time()

    def process(t, blk):
        """Produce and recurse into all child blocks of `blk` (level t)."""
        if verbose:
            import sys
            import time as _time

            live = stats.get("live_blocks", {})
            live[t] = sum(
                int(p.size) * p.dtype.itemsize for p in blk.U
            )
            stats["live_blocks"] = live
            print(
                f"[basis {_time.time()-stats['t0']:8.1f}s] level {t} "
                f"block rows={blk.nrows} chunks so far={stats['chunks']} "
                f"live block bytes≈{sum(live.values())/1e9:.2f}G",
                file=sys.stderr,
                flush=True,
            )
        child_level = t + 1
        k = r - t - 1  # original indices remaining after this step
        n_k = comb.indep_size(k, d)
        npar_pad = blk.npar
        Rc = R[child_level]
        if t == 0 and use_root_kernel:
            # Case-decomposed root pass (ops/basis_root.py): every read is
            # a contiguous slice or the shared-index axis-1 gather —
            # replaces the per-element gathers of the one-row step (9.2e9
            # incidences per window at rank-6 dim-100).
            from .basis_root import (
                chunk_cols,
                g_chunks,
                root_dus,
                root_pass_kernel,
                root_tables_jnp,
                split_root_groups,
            )

            # Chunk the host-unrolled g-loop into several programs: the
            # op count (~Σ(d−g) slice ops) drives compile memory and time,
            # so the k = 5 rank-6 root is split into ~9 programs at
            # d = 100; smaller k runs as one program per window (fewer
            # dispatches).  Budget chosen on the previous accelerator and
            # not yet re-decided for the GPU.
            budget = _env_int(
                "SYMTENSOR_BASIS_ROOT_SLICES", 600 if k >= 5 else 10_000
            )
            chunks = g_chunks(d, budget)
            rks = [
                root_pass_kernel(
                    k, d, Rc, str(store_dt), str(acc_dt),
                    tile_elems=transient_elems, g0=c0, g1=c1,
                )
                for c0, c1 in chunks
            ]
            ccols = [chunk_cols(k, d, c0, c1) for c0, c1 in chunks]
            IH_J = root_tables_jnp(k, d)
            # Split the flat root into per-group 2-D blocks ONCE (one
            # extra root-sized copy): feeding the flat buffer to the
            # window kernels let XLA retile it (N/10, 10), which a tiled
            # device layout pads (see basis_root module docstring).  After the split the flat
            # root is dead weight; with donate_root it is freed here,
            # BEFORE any window runs, not after the last one.
            groups_dev = split_root_groups(blk.U[0], k, d)
            traced = isinstance(groups_dev[-1], jax.core.Tracer)
            if donate_root and not traced:
                float(groups_dev[-1][0, 0])  # fence the split chain
                jnp.asarray(blk.U[0]).delete()
            # Attribution knob: SYMTENSOR_BASIS_ROOT_WINDOW_RANGE=lo:hi
            # processes only root windows with b_lo in [lo, hi) — the
            # output is then PARTIAL (other windows' subtrees never run);
            # for per-window cost attribution on the multi-hour flagship,
            # not for production use.
            wr = os.environ.get("SYMTENSOR_BASIS_ROOT_WINDOW_RANGE", "")
            win_rng = None
            if ":" in wr:
                lo_s, hi_s = wr.split(":", 1)
                win_rng = (int(lo_s), int(hi_s))
                # ALWAYS loud (not just verbose): if this attribution
                # knob leaks into a production shell the result tensor is
                # silently truncated and only accuracy checks would
                # notice
                import sys as _sys

                print(
                    "symtensor_tpu: PARTIAL OUTPUT — "
                    f"SYMTENSOR_BASIS_ROOT_WINDOW_RANGE={wr!r} skips every "
                    f"root window with b_lo outside [{win_rng[0]}, "
                    f"{win_rng[1]}); the returned tensor is incomplete "
                    "(attribution knob, not for production)",
                    file=_sys.stderr,
                    flush=True,
                )
            for b_lo in range(0, d_out, Rc):
                b_hi = min(b_lo + Rc, d_out)
                if win_rng and not (win_rng[0] <= b_lo < win_rng[1]):
                    continue
                root_ws = 4 * transient_elems  # per-piece gather transient
                isz = jnp.dtype(store_dt).itemsize
                if len(chunks) == 1:
                    child_U = rks[0](
                        tuple(groups_dev), Wdev, jnp.int32(b_lo), *IH_J
                    )
                    thr.add(Rc * n_k * isz, child_U, transient=root_ws)
                else:
                    child_U = jnp.zeros((Rc * n_k,), dtype=store_dt)
                    col = 0
                    for rk_c, nc, (c0, _c1) in zip(rks, ccols, chunks):
                        piece = rk_c(
                            tuple(groups_dev[c0:]), Wdev,
                            jnp.int32(b_lo), *IH_J
                        )
                        thr.add(Rc * nc * isz, piece, transient=root_ws)
                        child_U = root_dus(Rc, n_k, nc, str(store_dt))(
                            child_U, piece, col
                        )
                        col += nc
                    thr.add(Rc * n_k * isz, child_U)
                if b_hi >= d_out and not isinstance(
                    child_U, jax.core.Tracer
                ):
                    # last window: fence, then free the group blocks
                    # BEFORE the final subtree's recursion (.delete() is
                    # immediate, so consumers must have finished)
                    thr.drain() or float(child_U[0])
                    for gb in groups_dev:
                        jnp.asarray(gb).delete()
                    groups_dev.clear()
                if verbose:
                    import sys
                    import time as _time

                    print(
                        f"[basis {_time.time()-stats['t0']:8.1f}s] root "
                        f"window b=[{b_lo},{b_hi})",
                        file=sys.stderr, flush=True,
                    )
                stats["chunks"] += 1
                nsel = b_hi - b_lo
                sel_b = np.arange(b_lo, b_hi, dtype=np.int64)
                child = _Block(
                    (child_U,), sel_b,
                    sel_b[:, None].astype(np.int32), nsel, Rc, n_k,
                )
                process(child_level, child)
            return
        # Per-parent-row case-kernel scheduling for WIDE mid levels
        # (k ≥ 3).  The generic chunk schedule below re-gathers the whole
        # npar-row parent block for every ~wp-wide b-window of children:
        # at the rank-6 dim-100 t=1 step that is a ~10× re-read (each
        # chunk sweeps 10 × 4.4e8 insert incidences to emit ~55 children).
        # Treating each parent ROW as a root of the case-decomposed pass
        # (ops/basis_root.py) amortizes ONE sweep of that row over a full
        # w-wide window of its own children, and reads via contiguous
        # slices / shared axis-1 gathers instead of the per-element
        # gathers the generic kernel issues at npar = 1.
        row_incid = _env_int("SYMTENSOR_BASIS_ROW_INCID", 100_000_000)
        if (
            use_root_kernel
            and k >= 3
            and row_incid > 0
            and n_k * d >= row_incid
            and blk.nrows <= 128
            and len(blk.U) == 1
        ):
            from .basis_root import (
                chunk_cols,
                g_chunks,
                root_dus,
                root_pass_kernel,
                root_tables_jnp,
                split_root_groups,
            )

            w = int(min(d_out, Rc, row_w_cap))
            # k-dependent program budget, as for the root pass above
            budget = _env_int(
                "SYMTENSOR_BASIS_ROOT_SLICES", 600 if k >= 5 else 10_000
            )
            chunks_g = g_chunks(d, budget)
            rks = [
                root_pass_kernel(
                    k, d, w, str(store_dt), str(acc_dt),
                    tile_elems=transient_elems, g0=c0, g1=c1,
                )
                for c0, c1 in chunks_g
            ]
            ccols = [chunk_cols(k, d, c0, c1) for c0, c1 in chunks_g]
            IH_J = root_tables_jnp(k, d)
            width = blk.width
            isz = jnp.dtype(store_dt).itemsize
            root_ws = 4 * transient_elems
            for p in range(blk.nrows):
                m_p = int(blk.maxels[p])
                row = blk.U[0][p * width : (p + 1) * width]
                groups_dev = split_root_groups(row, k, d)
                # the split costs ~2 row copies; the sliced row itself is
                # dead once split — dropping the reference frees it as
                # the stream catches up (the throttle bounds the backlog)
                thr.add(2 * width * isz, groups_dev[-1])
                del row
                for b_lo in range(m_p, d_out, w):
                    b_hi = min(b_lo + w, d_out)
                    if len(chunks_g) == 1:
                        child_U = rks[0](
                            tuple(groups_dev), Wdev, jnp.int32(b_lo), *IH_J
                        )
                        thr.add(w * n_k * isz, child_U, transient=root_ws)
                    else:
                        child_U = jnp.zeros((w * n_k,), dtype=store_dt)
                        col = 0
                        for rk_c, nc, (c0, _c1) in zip(
                            rks, ccols, chunks_g
                        ):
                            piece = rk_c(
                                tuple(groups_dev[c0:]), Wdev,
                                jnp.int32(b_lo), *IH_J
                            )
                            thr.add(w * nc * isz, piece, transient=root_ws)
                            child_U = root_dus(w, n_k, nc, str(store_dt))(
                                child_U, piece, col
                            )
                            col += nc
                        thr.add(w * n_k * isz, child_U)
                    if b_hi >= d_out:
                        # last window of this row: its group blocks are
                        # dead — drop the references (freed once the
                        # queued windows finish; no fence needed)
                        groups_dev = []
                    if verbose:
                        import sys
                        import time as _time

                        print(
                            f"[basis {_time.time()-stats['t0']:8.1f}s] "
                            f"level {t} row {p} window b=[{b_lo},{b_hi})",
                            file=sys.stderr, flush=True,
                        )
                    stats["chunks"] += 1
                    nsel = b_hi - b_lo
                    sel_b = np.arange(b_lo, b_hi, dtype=np.int64)
                    child_reps = np.concatenate(
                        [
                            np.broadcast_to(blk.reps[p], (nsel, t)),
                            sel_b[:, None].astype(np.int32),
                        ],
                        axis=1,
                    )
                    child = _Block(
                        (child_U,), sel_b, child_reps, nsel, w, n_k
                    )
                    process(child_level, child)
            return
        # predict the insert-map form WITHOUT building it (the windowed
        # path wants host tables, never a full-size device upload)
        fused_here = (
            child_level == r
            and use_fused_emit
            and len(blk.U) == 1
            and blk.npar >= 2
            and mesh is None
        )
        onthefly = n_k * d > fly_limit
        _kern_cache = {}

        def get_kern(wpb):
            """Step kernel(s) for one b-window width bucket.

            The width is per-chunk ADAPTIVE (pow-2 bucketed): with the old
            static wp (≈2·Rc/npar), windows early in the b range yield
            almost no children — parents of b are a prefix of C(b+t, t+1)
            rows — so the step paid ~2.5× more full parent re-sweeps than
            ⌈level rows/Rc⌉ (rank-5 t=2→3: 15 sweeps of a 10.4 GB fan-out
            where 6 suffice).  The gather volume per sweep is
            width-independent, so wider windows cost little.  One
            compiled kernel per (level shape, bucket), disk-cached."""
            if wpb in _kern_cache:
                return _kern_cache[wpb]
            _kern_cache[wpb] = _build_kern(wpb)
            return _kern_cache[wpb]

        def _build_kern(wp):
            # per-segment-column transient cost: the (npar, seg, d)
            # gather, the (npar, seg, wp) product (wp counted as at least
            # 128) plus its (seg, npar·wp) transpose staging, plus — on
            # the on-the-fly path — the (seg, d, k+1) index construction.
            # The budget is DELIBERATELY larger than the generic
            # transient budget: each gather op has a fixed cost, so
            # fewer, bigger segments win as long as the (npar, seg, d)
            # workspace fits.
            cost = npar_pad * (d + 2 * max(wp, 128))
            if onthefly:
                # insert-ranking planes: cnt compares + masked FMA rows
                cost += d * (k + 2) * 3
            gather_elems = _env_int(
                "SYMTENSOR_BASIS_GATHER_ELEMS", 4 * transient_elems
            )
            seg = int(max(1, min(n_k, gather_elems // max(1, cost))))
            # Segment-count FLOOR: the per-gather-op fixed cost × nseg
            # grows with the segment count (1 247 deep chunks × ~10-19
            # segments each at rank-6, counted by schedule_sim).  Allow the
            # workspace to grow past the budget until a chunk runs in at
            # most SYMTENSOR_BASIS_MAX_NSEG segments, bounded by a hard
            # per-op workspace cap so huge (npar·d) chunks cannot OOM.
            nseg_cap = max(1, _env_int("SYMTENSOR_BASIS_MAX_NSEG", 4))
            hard = _env_int("SYMTENSOR_BASIS_SEG_HARD_ELEMS", 400_000_000)
            seg_floor = min(
                -(-n_k // nseg_cap), max(1, hard // max(1, cost))
            )
            seg = int(min(n_k, max(seg, seg_floor)))
            # Host-level COLUMN WINDOWING of long steps: a step with more
            # than SYMTENSOR_BASIS_MAX_SEGS map steps (the rank-6 t=0 root
            # pass has ~59k) runs as several programs over column windows.
            # Positions are computed from the table rows (absolute
            # multisets), so slicing the child-column axis into windows is
            # exact.  Window tables are sliced HOST-side and uploaded once
            # each (~46 MB at the rank-6 root), and outputs assemble into a
            # donated buffer via dynamic_update_slice (no 10-operand
            # concat transient).  The limits were set on the previous
            # accelerator and have not been re-decided for the GPU.
            max_segs = _env_int("SYMTENSOR_BASIS_MAX_SEGS", 6000)
            nseg_tot = -(-n_k // seg)
            piece_lens = tuple(int(p.shape[0]) for p in blk.U)
            mesh_axis = None if mesh is None else (mesh, tp_axis)
            # Window by table BYTES as well (SYMTENSOR_BASIS_MAX_TBL_BYTES).
            # 80 MB lets the 70.7 MB k=3 d=100 insert table run
            # monolithic — its 2-window split cost 862 extra window
            # dispatches + 163 GB of piece/dus churn at the rank-6
            # flagship.
            max_tbl = _env_int("SYMTENSOR_BASIS_MAX_TBL_BYTES", 80_000_000)
            if onthefly:
                it = 1 if d <= 127 else 2 if d <= 32767 else 4
                tbl_bytes = n_k * k * it
            else:
                tbl_bytes = n_k * d * 4
            # the select-staging matrix Ht = (n_k_window, npar·wp) must
            # stay under the fan budget (it is materialized whole per
            # window so the child select is ONE shared-index gather)
            fan_elems = _env_int("SYMTENSOR_BASIS_FAN_ELEMS", 2**28)
            ht_elems = n_k * npar_pad * wp
            nwin_req = max(
                -(-nseg_tot // max_segs),
                -(-tbl_bytes // max_tbl),
                -(-ht_elems // fan_elems),
            )
            if fused_here:
                return None, None, 0  # run_chunk takes the fused-emit path
            # per-dispatch workspace estimate for the throttle: one
            # segment's gather + product + staging, in acc bytes
            ws_est = 4 * seg * cost
            if nwin_req > 1 and n_k > 1:
                tbl_arg = insert_map_host(k, onthefly)
                nwin = nwin_req
                cols_raw = -(-n_k // nwin)
                win_cols = -(-cols_raw // seg) * seg  # multiple of seg
                bounds = [
                    (c0, min(c0 + win_cols, n_k))
                    for c0 in range(0, n_k, win_cols)
                ]
                kerns = [
                    _step_kernel(
                        blk.npar, piece_lens, c1 - c0, d, k, wp, Rc, seg,
                        str(store_dt), str(acc_dt), onthefly, mesh_axis,
                    )
                    for c0, c1 in bounds
                ]
                isz = jnp.dtype(store_dt).itemsize

                def kern(rows_pieces, tbl_host, Wm, b_lo, bs, st_, ct_,
                         _bounds=tuple(bounds), _kerns=tuple(kerns)):
                    buf = jnp.zeros((Rc * n_k,), dtype=store_dt)
                    for (c0, c1), kw in zip(_bounds, _kerns):
                        key = (t, k, c0, c1)
                        if key not in _win_tbls:
                            _win_tbls[key] = jnp.asarray(
                                tbl_host[c0 * k : c1 * k] if onthefly
                                else tbl_host[c0:c1]
                            )
                            thr.add(int(_win_tbls[key].nbytes))
                        w_out = kw(
                            rows_pieces, _win_tbls[key], Wm, b_lo, bs,
                            st_, ct_
                        )
                        # window output + workspace queue up without a
                        # per-window fence (~956 windows at the rank-6
                        # flagship); the throttle bounds the backlog
                        thr.add(
                            Rc * (c1 - c0) * isz, w_out,
                            transient=ws_est,
                        )
                        buf = _dus_combine(
                            Rc, n_k, c1 - c0, str(store_dt)
                        )(buf, w_out, jnp.int32(c0))
                    return buf

                return kern, tbl_arg, 0  # windows self-account above
            tbl_arg, _ = insert_map(k)
            return _step_kernel(
                blk.npar, piece_lens, n_k, d, k, wp, Rc, seg,
                str(store_dt), str(acc_dt), onthefly, mesh_axis,
            ), tbl_arg, ws_est

        # parents available per new max element b (prefix property)
        counts = np.searchsorted(
            blk.maxels, np.arange(d_out) + 1, side="left"
        )
        # Cap the chunk row padding by this block's actual total fan-out
        # (pow-2 bucketed so kernel variants stay bounded): deep blocks
        # fill as little as ~10-20 % of the static R[t] budget (rank-6
        # k=1: nsel_pad 16.7M for ~1.8M real children per block), which
        # inflated step outputs ~3× in allocation AND in their
        # nsel_pad-sized select/transpose device work.  Total ≤ Rc means
        # one b-sweep still collects everything, so chunk count is
        # unchanged.
        total_children = int(np.sum(d_out - blk.maxels))
        if 0 < total_children < Rc:
            p2 = 4096
            while p2 < total_children:
                p2 *= 2
            Rc = min(Rc, p2)
        wcap = step_wcap

        def _bucket_w(nw):
            wb = 4
            while wb < nw:
                wb *= 2
            return min(wb, wcap)

        b = int(np.argmax(counts > 0)) if counts[-1] > 0 else d_out
        while b < d_out:
            b_lo = b
            groups, nsel = [], 0
            while b < d_out and (b - b_lo) < wcap and nsel < Rc:
                c = int(counts[b])
                if c > Rc and nsel == 0:
                    # one b-group exceeds the row budget: emit it in
                    # parent-prefix pieces (window of width 1)
                    kern1, tbl1, ws1 = get_kern(4)
                    for p0 in range(0, c, Rc):
                        p1 = min(p0 + Rc, c)
                        run_chunk(
                            t, blk, kern1, tbl1, b,
                            [(b, p0, p1 - p0)], Rc, 4, ws1,
                        )
                    b += 1
                    b_lo = b
                    continue
                if nsel + c > Rc:
                    break
                groups.append((b, 0, c))
                nsel += c
                b += 1
            if nsel:
                wpb = _bucket_w(b - b_lo)
                kernb, tblb, wsb = get_kern(wpb)
                run_chunk(t, blk, kernb, tblb, b_lo, groups, Rc, wpb, wsb)

    # Split the root leaf into pieces under the gather-operand byte limit
    # (SYMTENSOR_GATHER_MAX_BYTES, set on the previous accelerator and not
    # yet re-decided for the GPU); a single piece means
    # the tensor's own leaf is used with no copy.  The case-decomposed root
    # kernel never gathers the full buffer (per-group slices only), so it
    # keeps the root whole.
    use_root_kernel = (
        r >= 4
        and mesh is None
        and os.environ.get("SYMTENSOR_BASIS_ROOT", "1") not in ("", "0")
    )
    use_fused_emit = (
        r >= 2
        and os.environ.get("SYMTENSOR_BASIS_FUSED_EMIT", "1")
        not in ("", "0")
    )
    root_vals = A.data.astype(store_dt)
    gmax = _env_int("SYMTENSOR_GATHER_MAX_BYTES", (1 << 31) - (1 << 27))
    nbytes = root_vals.size * root_vals.dtype.itemsize
    if use_root_kernel:
        nbytes = 0  # keep whole
    if mesh is not None:
        # Sharded mode keeps the root RESIDENT-SHARDED over tp (the t = 0
        # step masked-gathers per shard and psums children — see
        # _step_kernel shard_root); pad so the shards divide evenly.
        # Positions are < n by construction, so pads are never read.
        # The oversized-root split below cannot apply (pieces would break
        # the shard layout); a per-shard gather source above the
        # gather-operand limit is instead gathered in masked pieces
        # INSIDE the shard body (_step_kernel shard_root).
        ndev_tp = mesh.shape[tp_axis]
        nbytes = 0
        pad_root = (-root_vals.size) % ndev_tp
        if pad_root:
            root_vals = jnp.concatenate(
                [root_vals, jnp.zeros((pad_root,), root_vals.dtype)]
            )
        from jax.sharding import NamedSharding as _NS, PartitionSpec as _P

        root_vals = jax.device_put(
            root_vals, _NS(mesh, _P(tp_axis))
        ) if not isinstance(root_vals, jax.core.Tracer) else (
            jax.lax.with_sharding_constraint(
                root_vals, _NS(mesh, _P(tp_axis))
            )
        )
    if nbytes > gmax:
        npieces = -(-nbytes // gmax)
        L = -(-root_vals.size // npieces)
        pieces = tuple(
            root_vals[p * L : min((p + 1) * L, root_vals.size)]
            for p in range(npieces)
        )
        if donate_root and not isinstance(root_vals, jax.core.Tracer):
            # the slices above are real copies; the undivided buffer (and
            # A.data, which it aliases when no cast happened) is dead
            # weight for the rest of the recursion once the slices have
            # been computed (a scalar readback of each waits for it).
            for p in pieces:
                float(p[-1])
            jnp.asarray(root_vals).delete()
    else:
        pieces = (root_vals,)
    root = _Block(
        pieces,
        np.zeros(1, dtype=np.int64),
        np.zeros((1, 0), dtype=np.int32),
        1,
        1,
        comb.indep_size(r, d),
    )
    process(0, root)
    if mesh is not None:
        # strip the per-shard dump slots; the result stays tp-sharded
        out2 = out_buf.reshape(
            mesh.shape[tp_axis], out_base + _DUMP_SLOTS
        )[:, :out_base]
        return FlatSymmetricTensor._raw(
            r, d_out, out2.reshape(-1)[:n_out]
        )
    return FlatSymmetricTensor._raw(r, d_out, out_buf[:n_out])
