"""Multi-device execution over a jax.sharding.Mesh.

The reference is single-process (SURVEY.md §2: no distributed layer exists).
The scaling story for symmetric tensors is:

- **dp**: batch polynomial evaluations sharded over a data axis,
- **tp**: the packed independent-component axis sharded over a tensor axis —
  contractions reduce with one psum over the device interconnect.

Everything here uses `shard_map` with explicit `jax.lax` collectives; XLA
lowers them onto the interconnect (NCCL over NVLink on GPUs). No custom
transport (SURVEY.md §5 "distributed communication backend").
"""

from __future__ import annotations

import math
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.flat import FlatSymmetricTensor
from ..utils import combinatorics as comb
from ..utils.precision import value_prec


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """Build a mesh over the first ∏sizes available devices."""
    n = int(np.prod(axis_sizes))
    devs = np.array(jax.devices()[:n]).reshape(axis_sizes)
    return Mesh(devs, tuple(axis_names))


def _pad_len(n: int, parts: int) -> int:
    return (-n) % parts


def shard_flat(
    t: FlatSymmetricTensor, mesh: Mesh, axis: str
) -> FlatSymmetricTensor:
    """Place the packed value leaf with a NamedSharding over `axis`.
    Requires n divisible by the axis size (use padded ops otherwise)."""
    ntp = mesh.shape[axis]
    if t.data.shape[0] % ntp:
        raise ValueError(
            f"component count {t.data.shape[0]} not divisible by mesh axis "
            f"'{axis}' ({ntp}); use poly_eval_sharded which pads internally"
        )
    sharding = NamedSharding(mesh, P(axis))
    return FlatSymmetricTensor._raw(
        t.rank, t.dim, jax.device_put(t.data, sharding)
    )


def _colex_tables_padded(t, rank: int, ntp: int):
    """Static last-level EGF tables + colex-ordered value permutation,
    zero-padded so the component axis divides the tp axis."""
    levels = t.mono_tables_weighted(rank)
    par, mx, run = levels[-1]
    n = par.shape[0]
    pad = _pad_len(n, ntp)
    if pad:
        par = jnp.concatenate([par, jnp.zeros(pad, par.dtype)])
        mx = jnp.concatenate([mx, jnp.zeros(pad, mx.dtype)])
        run = jnp.concatenate([run, jnp.ones(pad, run.dtype)])
    # inverse colex permutation: vals_colex[c] = vals[inv[c]]; padding
    # slots point one past the end, at the zero the caller appends
    inv = jnp.argsort(t.colex_perm)
    if pad:
        inv = jnp.concatenate([inv, jnp.full(pad, n, inv.dtype)])
    return levels[:-1], (par, mx, run), inv


def poly_eval_batched_sharded(
    A: FlatSymmetricTensor,
    xs: jnp.ndarray,
    mesh: Mesh,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
) -> jnp.ndarray:
    """Batched full contraction Σ A·x⊗…⊗x with the batch sharded over
    `dp_axis` and the packed independent-component axis sharded over
    `tp_axis`; the component reduction is one psum.

    Returns (B,) results, sharded over dp.

    Memory note: each device gathers only its tp share of the colex-ordered
    values (from `A.data` as placed by the caller).  This colex-EGF
    formulation replicates all prior EGF
    levels per shard — the level-(r−1) intermediate is
    (B_local, C(d+r−2, r−1)) and is NOT bounded by tp sharding (only the
    last level's table traffic and the value axis are).  For large tensors
    prefer `poly_eval_batched_sharded_grouped`, which shards the grouped
    GEMM layout instead (per-head intermediates, no O(n) colex tables).
    """
    r, d = A.rank, A.dim
    if r < 2:
        # trivial ranks: replicate
        if r == 0:
            return jnp.broadcast_to(A.data[0], (xs.shape[0],))
        return jnp.dot(xs, A.data, precision=value_prec(A.dtype))
    ntp = mesh.shape[tp_axis]
    ndp = mesh.shape[dp_axis]
    B = xs.shape[0]
    if B % ndp:
        raise ValueError(f"batch {B} not divisible by dp axis ({ndp})")

    t = A.tables
    prior_levels, (par, mx, run), inv = _colex_tables_padded(t, r, ntp)
    # The gather writes the padded length itself.  Zero-padding its output
    # instead (concatenate after the gather) gives O(1)-wrong gradients
    # w.r.t. the values under jit whenever dp > 1: the partitioner
    # mis-slices the tp-sharded cotangent of that concatenate.
    vals_colex = jnp.concatenate([A.data, jnp.zeros(1, A.data.dtype)])[inv]

    def body(vals_s, par_s, mx_s, run_s, xs_s):
        # levels 1..r-1 are replicated work (size ≪ n); the big level-r
        # gather + dot happens on the local shard only.
        w = jnp.ones((xs_s.shape[0], 1), dtype=xs_s.dtype)
        for pl, ml, rl in prior_levels:
            w = w[:, pl] * xs_s[:, ml] / rl.astype(xs_s.dtype)
        w_last = w[:, par_s] * xs_s[:, mx_s] / run_s.astype(xs_s.dtype)
        # (B_local,); full f32 like the one-device path (value_prec): at
        # DEFAULT precision the GPU may run this dot and its transpose in
        # TF32, which put the dp×tp gradients 3e-4 off on four H100s
        partial_out = jnp.dot(
            w_last, vals_s.astype(xs_s.dtype),
            precision=value_prec(xs_s.dtype),
        )
        return jax.lax.psum(partial_out, tp_axis)

    out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(tp_axis), P(tp_axis), P(tp_axis), P(tp_axis), P(dp_axis, None)),
        out_specs=P(dp_axis),
    )(vals_colex, par, mx, run, xs)
    return float(math.factorial(r)) * out


def replicated(mesh: Mesh):
    """NamedSharding that replicates a leaf across the whole mesh."""
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Grouped sharded evaluation — the production multi-chip path
# ---------------------------------------------------------------------------


def shard_group_views(
    A: FlatSymmetricTensor, mesh: Mesh, tp_axis: str = "tp"
):
    """Split the packed values into the per-group matrices of the grouped
    GEMM kernel (kernels/poly_eval.py) and shard each matrix's *head* axis
    over `tp_axis`.  Every group GEMM then runs row-parallel: each device
    holds 1/n_tp of every group (≈ 1/n_tp of all values), and the final
    M̃-weighted head reduction contracts the sharded axis — XLA inserts one
    reduce per group.  No O(n) colex tables are touched."""
    from ..kernels.poly_eval import (
        _grouped_static,
        _is_transposed,
        group_views_premul,
    )

    views = group_views_premul(A)
    Ps, Ts, _, _ = _grouped_static(A.rank, A.dim)
    ntp = mesh.shape[tp_axis]
    out = []
    for j, V in enumerate(views):
        # transposed narrow-tail views are (T_j, P_j): head axis is axis 1
        head_ax = 1 if _is_transposed(Ps[j], Ts[j]) else 0
        if V.shape[head_ax] % ntp == 0:
            spec = P(None, tp_axis) if head_ax else P(tp_axis, None)
        elif V.shape[1 - head_ax] % ntp == 0:
            spec = P(tp_axis, None) if head_ax else P(None, tp_axis)
        else:
            # tiny/indivisible group: replicate (cheap — group sizes fall
            # off steeply at both ends of j)
            spec = P()
        out.append(jax.device_put(V, NamedSharding(mesh, spec)))
    return tuple(out)


def poly_eval_batched_sharded_grouped(
    A: FlatSymmetricTensor,
    xs: jnp.ndarray,
    mesh: Mesh,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
    views=None,
) -> jnp.ndarray:
    """Batched full contraction on the grouped GEMM layout with the batch
    over `dp_axis` and every group's head axis over `tp_axis`.

    This is the single-chip benchmark kernel made multi-chip by sharding
    annotations alone: the jnp body is identical; GSPMD partitions each
    (B, T_j) @ (T_j, P_j) GEMM over rows of P_j and reduces the sharded
    head contraction.  Per-device residency: values/n_tp + the
    replicated head-monomial table (C(d+r−4, r−3) ≪ n).

    Pass precomputed `views` (from shard_group_views) to amortize placement
    across calls.  Returns (B,), sharded over dp.
    """
    from ..kernels.poly_eval import _views_eval_batched_premul_jitted

    r, d = A.rank, A.dim
    xs = jnp.asarray(xs)
    if r < 3:
        # trivial ranks: data-parallel only
        xs = jax.device_put(xs, NamedSharding(mesh, P(dp_axis, None)))
        if r == 0:
            return jnp.broadcast_to(A.data[0], (xs.shape[0],))
        if r == 1:
            return jnp.dot(xs, A.data.astype(xs.dtype),
                           precision=value_prec(xs.dtype))
        from ..ops.contract import contract_all_indices_with_vector_batched

        return contract_all_indices_with_vector_batched(A, xs)
    if views is None:
        views = shard_group_views(A, mesh, tp_axis)
    xs = jax.device_put(xs, NamedSharding(mesh, P(dp_axis, None)))
    out = _views_eval_batched_premul_jitted(r, d)(views, xs)
    return jax.lax.with_sharding_constraint(
        out, NamedSharding(mesh, P(dp_axis))
    )


def tensordot_sharded(
    a, b, axes: int, mesh: Mesh, axis: str = "tp",
    operands: str = "replicated",
):
    """Symmetrized streamed tensordot with OUTPUT BLOCKS partitioned over
    a mesh axis.

    Every device ranks its blocks' gather positions in-kernel (closed-form
    gflat addressing — no index tables cross the wire).  Two operand
    placements:

    - ``operands="replicated"`` (default): operands are replicated to
      every device; the only communication is the output all-gather.
      Compute scales with the axis; memory does not.
    - ``operands="sharded"``: the operand value axes stay SHARDED over
      `axis` — per-device residency is 1/n_axis of each operand (the
      memory-scaling mode for operands too big for one device).  Each output
      block accumulates its gathers over a ring: n_axis
      ppermute-rotate + masked-local-gather steps reassemble exactly the
      values the block needs.  Communication model: each device moves the
      full operand bytes over the interconnect once per LOCAL block
      (nblk/n_axis blocks), instead of holding them resident — the
      classic memory-for-bandwidth trade; transfers are whole-shard
      ppermutes.

    Semantics match ops.outer.tensordot(..., stream=True) (reference
    symalg.py:424-459, which has no distributed analog at all).
    """
    if operands == "sharded":
        return _tensordot_sharded_operands(a, b, axes, mesh, axis)
    if operands != "replicated":
        raise ValueError(f"unknown operands mode {operands!r}")
    from functools import partial as _partial

    from ..ops import outer as outer_mod
    from ..utils.tables import tables

    af, _ = outer_mod._as_flat(a)
    bf, _ = outer_mod._as_flat(b)
    ra, rb, k = af.rank, bf.rank, int(axes)
    if k > min(ra, rb) or k < 1:
        raise ValueError(
            f"cannot contract {k} axes between ranks {ra} and {rb}"
        )
    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim = af.dim
    r_out = ra + rb - 2 * k
    t_out = tables(r_out, dim)
    n_out = t_out.n
    ndev = mesh.shape[axis]

    tk = tables(k, dim)
    creps_T = tk._memo(
        "creps_T", lambda: jnp.asarray(tk.rep_np().astype(np.int32).T)
    )
    gam = tk.multiplicity
    n_k = creps_T.shape[1]
    n_sub = comb.binom(r_out, ra - k)
    idt = outer_mod._stream_idt(dim)

    per_elem = max(1, n_k * (ra - k + rb - k + k)) * max(1, min(n_sub, 4))
    B = max(1, min(n_out, outer_mod._streamed_block_elems() // per_elem))
    nblk = -(-n_out // B)
    nblk = -(-nblk // ndev) * ndev  # block count divisible by the axis
    pad = nblk * B - n_out

    def build_rep_pad():
        rep_flat = jnp.asarray(
            t_out.rep_np().astype(idt).reshape(-1)
            if r_out > 0
            else np.zeros((0,), idt)
        )
        if pad:
            rep_flat = jnp.concatenate(
                [rep_flat, jnp.zeros((pad * r_out,), rep_flat.dtype)]
            )
        return rep_flat

    rep_pad = t_out._memo(
        ("rep_pad_sharded", np.dtype(idt).name, B, ndev), build_rep_pad
    )

    body = outer_mod._streamed_jitted(
        ra, rb, k, dim, str(jnp.dtype(af.dtype)), int(B),
        int(nblk // ndev), trim=False,
    )

    fn = jax.shard_map(
        lambda ad, bd, rp, ct, gm: body(ad, bd, rp.reshape(-1), ct, gm),
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    out = fn(
        af.data, bf.data, rep_pad.reshape(nblk, B * r_out), creps_T, gam
    )
    out = out.reshape(-1)[:n_out]
    if r_out == 0:
        return FlatSymmetricTensor._raw(0, 1, out[:1])
    return FlatSymmetricTensor._raw(r_out, dim, out)


def _tensordot_sharded_operands(a, b, axes: int, mesh: Mesh, axis: str):
    """Memory-scaling streamed tensordot: operand value axes sharded over
    `axis`; each output block ring-accumulates its gathered values.

    Per ring step every device holds ONE rotating shard of each operand;
    positions falling inside the resident shard are gathered locally (the
    rest masked to zero), and after n_axis ppermute rotations every
    block's (n_sub, n_k, B) gather workspaces are complete.  Peak
    per-device residency: operands/n_axis + the block workspaces — the
    full operands never exist on any device.  See `tensordot_sharded` for
    the communication model."""
    import itertools as _it

    from ..ops import outer as outer_mod
    from ..ops.outer import _stream_pos_of_T
    from ..utils.precision import value_prec
    from ..utils.tables import tables

    af, _ = outer_mod._as_flat(a)
    bf, _ = outer_mod._as_flat(b)
    ra, rb, k = af.rank, bf.rank, int(axes)
    if k > min(ra, rb) or k < 1:
        raise ValueError(
            f"cannot contract {k} axes between ranks {ra} and {rb}"
        )
    if af.dim != bf.dim:
        raise ValueError(f"dim mismatch: {af.dim} vs {bf.dim}")
    dim = af.dim
    ka, kb = ra - k, rb - k
    r_out = ka + kb
    t_out = tables(r_out, dim)
    t_a, t_b = tables(ra, dim), tables(rb, dim)
    n_out = t_out.n
    ndev = mesh.shape[axis]
    dt = jnp.dtype(af.dtype)

    tk = tables(k, dim)
    creps_T = tk._memo(
        "creps_T", lambda: jnp.asarray(tk.rep_np().astype(np.int32).T)
    )
    gam = tk.multiplicity
    n_k = creps_T.shape[1]
    subsets = list(_it.combinations(range(r_out), ka))
    n_sub = len(subsets)
    idt = outer_mod._stream_idt(dim)

    # block size: the ring keeps TWO (n_sub, n_k, B) workspaces resident
    per_elem = max(1, 2 * n_sub * n_k)
    B = max(1, min(n_out, outer_mod._streamed_block_elems() // per_elem))
    nblk = -(-n_out // B)
    nblk = -(-nblk // ndev) * ndev
    pad = nblk * B - n_out

    rep_flat = jnp.asarray(
        t_out.rep_np().astype(idt).reshape(-1)
        if r_out > 0
        else np.zeros((0,), idt)
    )
    if pad:
        rep_flat = jnp.concatenate(
            [rep_flat, jnp.zeros((pad * r_out,), rep_flat.dtype)]
        )

    # pad the operand value axes so they split evenly over the mesh axis
    def pad_to(v, parts):
        p = _pad_len(v.shape[0], parts)
        return (
            jnp.concatenate([v, jnp.zeros((p,), v.dtype)]) if p else v
        ), (v.shape[0] + p) // parts

    a_pad, La = pad_to(af.data, ndev)
    b_pad, Lb = pad_to(bf.data, ndev)

    def body(a_sh, b_sh, rp, ct, gm):
        # a_sh: (La,) local shard; rp: (nblk/ndev, B·r_out) local blocks
        gm_dt = gm.astype(dt)
        me = jax.lax.axis_index(axis)

        def blk(rep_blk_flat):
            rep_T = (
                rep_blk_flat.reshape(B, r_out).astype(jnp.int32).T
                if r_out
                else jnp.zeros((0, B), jnp.int32)
            )
            pas, pbs = [], []
            for S in subsets:
                Sc = tuple(i for i in range(r_out) if i not in S)
                ia = jnp.broadcast_to(
                    rep_T[list(S), None, :], (ka, n_k, B)
                )
                ib = jnp.broadcast_to(
                    rep_T[list(Sc), None, :], (kb, n_k, B)
                )
                pas.append(_stream_pos_of_T(t_a, ia, ra, ct, k, n_k))
                pbs.append(_stream_pos_of_T(t_b, ib, rb, ct, k, n_k))
            pa = jnp.stack(pas)  # (n_sub, n_k, B) int32
            pb = jnp.stack(pbs)

            def ring(carry, _):
                a_cur, b_cur, sid, av, bv = carry
                loa = pa - sid * La
                ma = (loa >= 0) & (loa < La)
                av = av + jnp.where(
                    ma, a_cur[jnp.clip(loa, 0, La - 1)],
                    jnp.zeros((), dt),
                )
                lob = pb - sid * Lb
                mb = (lob >= 0) & (lob < Lb)
                bv = bv + jnp.where(
                    mb, b_cur[jnp.clip(lob, 0, Lb - 1)],
                    jnp.zeros((), dt),
                )
                perm = [(j, (j + 1) % ndev) for j in range(ndev)]
                a_nxt = jax.lax.ppermute(a_cur, axis, perm)
                b_nxt = jax.lax.ppermute(b_cur, axis, perm)
                # after the rotation this device holds the shard that was
                # one device to the left
                sid_nxt = (sid - 1) % ndev
                return (a_nxt, b_nxt, sid_nxt, av, bv), None

            init = (
                a_sh,
                b_sh,
                me,
                jnp.zeros((n_sub, n_k, B), dt),
                jnp.zeros((n_sub, n_k, B), dt),
            )
            (_, _, _, av, bv), _ = jax.lax.scan(
                ring, init, None, length=ndev
            )
            acc = jnp.einsum(
                "c,scb->b", gm_dt, av * bv, precision=value_prec(dt)
            )
            return acc / n_sub

        return jax.lax.map(blk, rp)

    fn = jax.shard_map(
        lambda ad, bd, rp, ct, gm: body(ad, bd, rp, ct, gm),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    out = fn(
        a_pad, b_pad, rep_flat.reshape(nblk, B * r_out), creps_T,
        gam,
    )
    out = out.reshape(-1)[:n_out]
    if r_out == 0:
        return FlatSymmetricTensor._raw(0, 1, out[:1])
    return FlatSymmetricTensor._raw(r_out, dim, out)
