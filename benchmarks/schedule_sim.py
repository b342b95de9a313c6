"""Host-side schedule simulator for the blocked basis change.

The blocked recursion's SCHEDULE (which chunks run, their shapes, how many
dispatches/fences/uploads happen) is pure host-side bookkeeping — device
values never influence it.  This script monkeypatches every device kernel
with a shape-faithful fake (zeros of the right shape) and runs
`basis_change_packed` at flagship sizes on CPU, recording one event per
dispatch.  Output: per-phase dispatch counts and element volumes (gather,
output, scatter slots), plus the throttle's fence count.  It models no
device time: rates come from a trace on the GPU.

Usage: python benchmarks/schedule_sim.py [rank dim] [--bf16]
Writes nothing to the device; runs in seconds at rank-5 dim-100.
"""

import os
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

import symtensor_tpu  # noqa: F401  (registers formats)
from symtensor_tpu.core.flat import FlatSymmetricTensor
from symtensor_tpu.ops import basis_change as bc
from symtensor_tpu.ops import basis_root as br
from symtensor_tpu.utils import combinatorics as comb

EVENTS = []


def _fz(shape, dt):
    """Allocation-free fake device buffer: a numpy broadcast view (strides
    0).  Supports everything the scheduler touches on block values —
    shape/size/dtype, slicing, float(x[i]) fences — without memsetting
    hundreds of GB (the first rank-6 sim spent ~35 min in zeros())."""
    return np.broadcast_to(np.dtype(dt).type(0), shape)


def _rec(kind, **kw):
    EVENTS.append((kind, kw))


def patch():
    # ---- step kernel ----
    real_step = bc._step_kernel.__wrapped__  # noqa: F841  (doc anchor)

    def fake_step(npar, piece_lens, n_k, d, k, wp, nsel_pad, seg,
                  store_dt, acc_dt, onthefly, mesh_axis=None):
        def kern(rows_pieces, tbl, Wm, b_lo, bs, st, ct):
            _rec(
                "step", npar=npar, n_k=n_k, k=k, wp=wp,
                nsel_pad=nsel_pad, seg=seg,
                gather_elems=npar * n_k * d,
                out_elems=nsel_pad * n_k,
            )
            return _fz((nsel_pad * n_k,), store_dt)

        return kern

    bc._step_kernel = fake_step

    def fake_emit2(r, d_out, n_out, nsel_pad, store_dt):
        def kern(out, vals, reps_flat, bs, st, ct):
            _rec("emit", nsel_pad=nsel_pad, slots=nsel_pad, fused=False)
            return out

        return kern

    bc._emit_kernel2 = fake_emit2

    def fake_fused(r, d, d_out, n_out, npar, w_pad, store_dt, acc_dt,
                   npar_eff=None):
        ne = npar if npar_eff is None else npar_eff

        def kern(out, rows_flat, Wm, b_lo, st, ct, reps_flat):
            _rec(
                "emit", nsel_pad=ne * w_pad, slots=ne * w_pad,
                fused=True, npar=ne, wp=w_pad,
                read_elems=ne * d,
            )
            return out

        return kern

    bc._fused_leaf_emit = fake_fused

    def fake_dus(nsel_pad, n_k, nkw, store_dt):
        def put(buf, piece, c0):
            _rec("dus", elems=nsel_pad * nkw)
            return buf

        return put

    bc._dus_combine = fake_dus

    # ---- root-pass kernels ----
    def fake_root(k, d, npar, store_dt, acc_dt, tile_elems=200_000_000,
                  g0=0, g1=None):
        cols = br.chunk_cols(k, d, g0, d if g1 is None else g1)

        def kern(Bs, Wp, b_lo, IH, J):
            _rec(
                "root", k=k, npar=npar, g0=g0,
                g1=(d if g1 is None else g1),
                cols=cols, out_elems=npar * cols,
            )
            return _fz((npar * cols,), store_dt)

        return kern

    br.root_pass_kernel = fake_root

    def fake_root_dus(npar, n_k, cols, store_dt):
        def put(buf, piece, c0):
            _rec("root_dus", elems=npar * cols)
            return buf

        return put

    br.root_dus = fake_root_dus

    real_split = br.split_root_groups

    def fake_split(A_flat, k, d):
        _rec("split_root", elems=int(np.prod(A_flat.shape)))
        shapes = br.group_shapes(k, d)
        return [_fz(s, A_flat.dtype) for s in shapes]

    br.split_root_groups = fake_split
    return real_split


def main():
    rank = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    sdt = jnp.bfloat16 if "--bf16" in sys.argv else jnp.float32
    patch()
    from symtensor_tpu.config import config

    config.max_table_entries = 3_000_000_000
    n = comb.indep_size(rank, dim)
    A = FlatSymmetricTensor._raw(rank, dim, jnp.zeros((n,), sdt))
    W = jnp.eye(dim, dtype=jnp.float32)
    kw = dict(
        store_dtype=sdt,
        block_elems=int(os.environ.get(
            "SYMTENSOR_FLAGSHIP_BLOCK_ELEMS",
            1_900_000_000 if sdt == jnp.float32 else 2_000_000_000,
        )),
        transient_elems=int(os.environ.get(
            "SYMTENSOR_FLAGSHIP_TRANSIENT_ELEMS", 50_000_000)),
        onthefly_above=250_000_000,
    )
    bc.basis_change_packed(A, W, **kw)

    # ---- summary ----
    phases = defaultdict(lambda: defaultdict(float))
    for kind, kwd in EVENTS:
        key = kind if kind != "step" else f"step k={kwd['k']}"
        p = phases[key]
        p["n"] += 1
        for fld in ("gather_elems", "out_elems", "slots", "elems",
                    "read_elems", "cols"):
            if fld in kwd:
                p[fld] += kwd[fld]
    print(f"rank={rank} dim={dim} store={jnp.dtype(sdt).name} "
          f"events={len(EVENTS)}")
    for key in sorted(phases):
        p = phases[key]
        print(f"  {key:14s} n={int(p['n']):6d}  " + "  ".join(
            f"{f}={p[f]:.3g}" for f in
            ("gather_elems", "out_elems", "slots", "elems", "read_elems")
            if p.get(f)))
    thr = bc._LAST_THROTTLE
    if thr is not None:
        print(f"throttle: {thr.fences} fences over {thr.adds} dispatches "
              f"(budget {thr.budget/1e9:.1f} GB)"
              + (f" [legacy cadence {thr.every}]" if thr.every else ""))


if __name__ == "__main__":
    main()
