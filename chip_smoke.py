"""Smoke run of symtensor's main path on one NVIDIA GPU.

    python chip_smoke.py               # phases 0-5 on one GPU
    python chip_smoke.py --four-cards  # the sharded path on four GPUs only

Every phase drives the public entry points (``symtensor_tpu.symalg``,
``models.polynomial``, ``parallel``) at the widths of the repo's headline
configuration, compares each result with an independent reference and
prints one line per check:

    phase<k> {"what", "size", "cold_s", "warm_s", "ref", "err", "tol", "ok"}

``cold_s`` is the first call (compilation and view building included),
``warm_s`` the median of at least five later calls, each fenced with
``jax.block_until_ready``.  The card's name and power limit come from
``nvidia-smi`` on the line before the last.  The last line is the JSON
contract ``{"ok": true, "device": {...}}``, printed only when every check
passed.  Without a GPU the script exits non-zero before any phase runs.

Tolerances.  Full contractions are built so that their terms do not
cancel (nonnegative vectors, or nonnegative tensor entries), and are
scored by relative error; batches and whole tensors by max|Δ|/max|y|.
Without cancellation a float32 sum over groups of at most a few thousand
terms, taken in an order the GPU chooses, stays near 1e-6 relative with
random rounding; 1e-4 leaves room for worst-case growth, while a wrong
multiplicity, position or layout gives an error of order 1e-3 to 1.  The
one signed contraction (iid values against the plain reference, both in
float32) is scored the same way: both sides round alike.  bf16 storage
keeps 8 mantissa bits, so its tolerance is 2e-2.

The batched f32 check (phase 2) also guards the precision policy
(utils/precision.py), so its tolerance is 1e-5: on an H100 the policy's
full-f32 dots gave 3.0e-7 there, while TF32 dots (the GPU's DEFAULT for
float32) gave 1.25e-4, and a precision that falls back to TF32 fails it
by a factor of ten.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

TOL_F32 = 1e-4
TOL_BATCH_F32 = 1e-5
TOL_BF16 = 2e-2
WARM_CALLS = 5


# ---------------------------------------------------------------------------
# sizes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Sizes:
    copy_bytes: int
    head_rank: int          # headline vector contraction
    head_dim: int
    simple_dim: int         # iid values vs _contract_vec_flat_simple
    small_dim: int          # dense float64 einsum checks
    batch_rank: int
    batch_dim: int
    batch: int
    bc_dim: int             # basis change, rank 4 (small route) and rank 5
    bc_block_elems: int
    c1_dim: int
    c3_dim: int
    c4_dim: int
    model_dim: int
    model_batch: int
    four_head_rank: int     # --four-cards sharded eval
    four_head_dim: int
    four_bc_dim: int
    four_td_dim: int
    four_batch: int


# The repo's headline: rank 6, dim 100, n = C(105, 6) = 1,609,344,100 f32
# components (6.44 GB); the BASELINE.json configs at their stated widths.
FULL = Sizes(
    copy_bytes=4_400_000_000,
    head_rank=6, head_dim=100,
    simple_dim=40,
    small_dim=12,
    batch_rank=4, batch_dim=100, batch=1024,
    bc_dim=100, bc_block_elems=1_900_000_000,
    c1_dim=30, c3_dim=200, c4_dim=64,
    model_dim=100, model_batch=1024,
    four_head_rank=6, four_head_dim=100,
    four_bc_dim=100, four_td_dim=30, four_batch=1024,
)

# Tiny shapes for the CPU test of each phase function.
SMALL = Sizes(
    copy_bytes=4_000_000,
    head_rank=6, head_dim=7,
    simple_dim=5,
    small_dim=4,
    batch_rank=4, batch_dim=6, batch=16,
    bc_dim=5, bc_block_elems=2_000,
    c1_dim=4, c3_dim=9, c4_dim=5,
    model_dim=5, model_batch=8,
    four_head_rank=5, four_head_dim=8,
    four_bc_dim=6, four_td_dim=5, four_batch=8,
)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


class Report:
    """Collects one line per check; ``ok`` is False once any check fails."""

    def __init__(self, out=sys.stdout):
        self.out = out
        self.ok = True
        self.rows = []

    def add(self, phase, what, size, ref, err, tol, cold_s=None, warm_s=None,
            **extra):
        ok = bool(np.isfinite(err) and err <= tol)
        row = {"what": what, "size": size, "cold_s": cold_s,
               "warm_s": warm_s, "ref": ref, "err": float(err), "tol": tol,
               "ok": ok, **extra}
        self.rows.append(row)
        self.ok &= ok
        print(f"phase{phase} {json.dumps(row)}", file=self.out, flush=True)
        return ok

    def note(self, phase, **info):
        print(f"phase{phase} {json.dumps(info)}", file=self.out, flush=True)


def timed(fn, warm=WARM_CALLS):
    """(result, cold seconds, median warm seconds) of ``fn()``."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    ts = []
    for _ in range(warm):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return out, cold, float(np.median(ts)) if ts else None


def rank_one_sum(rank, dim, lam, vs, dtype=jnp.float32):
    """Packed values of A = Σ_k lam_k v_k^{⊗rank}, built group by group.

    In the grouped storage layout (kernels/poly_eval.py) group j holds the
    multisets (head ≤ j, j, tail pair a ≤ b with a ≥ j) as a (P_j, T_j)
    row-major block, so its values are the outer product of head
    monomials m_h(v) (colex) with v_j·v_a·v_b (row-major triangle).  The
    evaluation kernels never see that A is a rank-one sum, so
    A·x^{⊗r} = Σ lam_k (v_k·x)^r is an independent reference at any width.
    """
    from symtensor_tpu.kernels.poly_eval import _grouped_static
    from symtensor_tpu.utils.tables import tables

    assert rank >= 3
    P, T, _, toff = _grouped_static(rank, dim)
    t = tables(rank, dim)
    lam = jnp.asarray(lam, jnp.float32)
    vs = jnp.asarray(vs, jnp.float32)  # (K, dim)
    mono = jnp.ones((vs.shape[0], 1), jnp.float32)
    for k in range(1, rank - 2):  # colex head monomials, sizes 1..rank-3
        par, mx = t.mono_tables(k)
        mono = mono[:, par] * vs[:, mx]
    ta, tb = t.tri_pairs

    @jax.jit
    def build(lam, vs, mono):
        tri = vs[:, ta] * vs[:, tb]  # (K, d(d+1)/2)
        parts = []
        for j in range(dim):
            head = lam[:, None] * mono[:, : P[j]]  # (K, P_j)
            tail = vs[:, j : j + 1] * tri[:, toff[j] : toff[j] + T[j]]
            blk = jnp.einsum("kp,kt->pt", head, tail,
                             precision=jax.lax.Precision.HIGHEST)
            parts.append(blk.reshape(-1).astype(dtype))
        return jnp.concatenate(parts)

    return build(lam, vs, mono)


def rank_one_ref(lam, vs, x, rank):
    """float64 host value of Σ lam_k (v_k·x)^rank and its absolute bound
    Σ |lam_k| (|v_k|·|x|)^rank."""
    lam = np.asarray(lam, np.float64)
    vs = np.asarray(vs, np.float64)
    x = np.asarray(x, np.float64)
    val = float(np.sum(lam * (vs @ x) ** rank))
    bound = float(np.sum(np.abs(lam) * (np.abs(vs) @ np.abs(x)) ** rank))
    return val, bound


def rank_one_ref_batched(lam, vs, xs, rank):
    lam = np.asarray(lam, np.float64)
    vs = np.asarray(vs, np.float64)
    xs = np.asarray(xs, np.float64)
    return ((xs @ vs.T) ** rank) @ lam  # (B,)


def norm_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-300))


def dense_contract(D, x):
    out = np.asarray(D, np.float64)
    for _ in range(out.ndim):
        out = out @ np.asarray(x, np.float64)
    return float(out)


def random_dense_symmetric(rank, dim, rng):
    from symtensor_tpu.testing.utils import random_symmetric

    return random_symmetric(rank, dim, rng=rng, dtype=np.float64)


def free(*arrays):
    for a in arrays:
        if isinstance(a, jax.Array) and not a.is_deleted():
            a.delete()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0_device(rep: Report, S: Sizes):
    """Device facts and the measured copy rate (yardstick for phase 1)."""
    from symtensor_tpu.config import DEFAULT_CACHE_DIR

    rep.note(0, jax=jax.__version__, devices=[str(d) for d in jax.devices()],
             compile_cache=jax.config.jax_compilation_cache_dir,
             default_cache=DEFAULT_CACHE_DIR,
             matmul_precision_default=str(
                 jax.config.jax_default_matmul_precision))
    n = S.copy_bytes // 4
    a = jnp.arange(n, dtype=jnp.float32)
    copy = jax.jit(lambda v: v * 1.0)
    out, cold, warm = timed(lambda: copy(a))
    err = float(jnp.max(jnp.abs(out - a)))
    copy_rate = 2 * a.nbytes / warm  # bytes read + written per second
    free(out)
    read = jax.jit(lambda v: jnp.max(v))
    top, _, warm_r = timed(lambda: read(a))
    read_rate = a.nbytes / warm_r
    err = max(err, abs(float(top) - float(a[-1])))
    rep.add(0, "device copy v*1.0 (read+write) and read-only max",
            f"{a.nbytes} bytes f32", "input values", err, 0.0, cold, warm,
            copy_GBps=copy_rate / 1e9, read_GBps=read_rate / 1e9)
    free(a)
    return copy_rate, read_rate


def phase1_headline(rep: Report, S: Sizes, copy_rate: float, read_rate: float,
                    seed: int = 0):
    """Headline vector contraction, eager (cached premultiplied views) and
    under a caller's jit over A (barrier path)."""
    import symtensor_tpu as st
    from symtensor_tpu import symalg
    from symtensor_tpu.ops.contract import _contract_vec_flat_simple
    from symtensor_tpu.utils import combinatorics as comb

    r, d = S.head_rank, S.head_dim
    n = comb.indep_size(r, d)
    size = f"rank-{r} dim-{d} f32 n={n}"
    rng = np.random.default_rng(seed)
    jit_eval = jax.jit(symalg.contract_all_indices_with_vector)

    # (a) constant tensor: A·x^r = (Σx)^r; positive x, so no cancellation
    A = st.FlatSymmetricTensor(rank=r, dim=d, data=jnp.ones((n,), jnp.float32))
    x = rng.uniform(0.0, 1.0, size=d).astype(np.float32)
    want = float(np.sum(x.astype(np.float64))) ** r
    xj = jnp.asarray(x)
    got, cold, warm = timed(lambda: symalg.contract_all_indices_with_vector(A, xj))
    nbytes = n * 4
    rep.add(1, "eager (premultiplied views), constant A", size,
            "(sum x)^r float64", abs(float(got) - want) / want, TOL_F32,
            cold, warm, GBps=nbytes / warm / 1e9,
            share_of_copy_rate=nbytes / warm / copy_rate,
            share_of_read_rate=nbytes / warm / read_rate)
    got, cold, warm = timed(lambda: jit_eval(A, xj))
    rep.add(1, "jit over A (barrier path), constant A", size,
            "(sum x)^r float64", abs(float(got) - want) / want, TOL_F32,
            cold, warm, GBps=nbytes / warm / 1e9)
    free(A.data, *getattr(A, "_group_views_premul", ()))
    del A

    # (b) random rank-one sum Σ lam v^{⊗r} with signed lam: independent
    # closed form at full width; v, x ≥ 0, so the bound is within a
    # factor of the value
    K = 4
    lam = rng.normal(size=K).astype(np.float32)
    vs = rng.uniform(0.0, 1.0, size=(K, d)).astype(np.float32)
    A = st.FlatSymmetricTensor(rank=r, dim=d, data=rank_one_sum(r, d, lam, vs))
    x = rng.uniform(0.0, 1.0, size=d).astype(np.float32)
    want, bound = rank_one_ref(lam, vs, x, r)
    xj = jnp.asarray(x)
    got, cold, warm = timed(lambda: symalg.contract_all_indices_with_vector(A, xj))
    rep.add(1, "eager (premultiplied views), random rank-one sum", size,
            "sum lam (v.x)^r float64, error / sum |lam| (|v|.|x|)^r",
            abs(float(got) - want) / bound, TOL_F32, cold, warm,
            GBps=nbytes / warm / 1e9)
    got_j, cold, warm = timed(lambda: jit_eval(A, xj))
    rep.add(1, "jit over A (barrier path), random rank-one sum", size,
            "sum lam (v.x)^r float64, error / bound",
            abs(float(got_j) - want) / bound, TOL_F32, cold, warm)
    free(A.data, *getattr(A, "_group_views_premul", ()))
    del A

    # (c) iid values vs the plain EGF reference at HIGHEST; its O(n)
    # monomial tables cap the width it can run at
    ds = S.simple_dim
    ns = comb.indep_size(r, ds)
    vals = rng.normal(size=ns).astype(np.float32)
    xj = jnp.asarray(rng.normal(size=ds).astype(np.float32))
    A = st.FlatSymmetricTensor(rank=r, dim=ds, data=jnp.asarray(vals))
    with jax.default_matmul_precision("highest"):
        want = float(_contract_vec_flat_simple(A, xj))
    got, cold, warm = timed(
        lambda: symalg.contract_all_indices_with_vector(A, xj))
    got_j = jit_eval(A, xj)
    rep.add(1, "eager, iid values", f"rank-{r} dim-{ds} f32 n={ns}",
            "_contract_vec_flat_simple HIGHEST, relative",
            abs(float(got) - want) / abs(want), TOL_F32, cold, warm)
    rep.add(1, "jit over A, iid values", f"rank-{r} dim-{ds} f32 n={ns}",
            "_contract_vec_flat_simple HIGHEST, relative",
            abs(float(got_j) - want) / abs(want), TOL_F32)

    # (d) small width vs a float64 dense einsum (nonnegative entries)
    dd = S.small_dim
    D = np.abs(random_dense_symmetric(r, dd, rng))
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(D, jnp.float32))
    x = rng.uniform(0.0, 1.0, size=dd)
    want = dense_contract(D, x)
    xj = jnp.asarray(x, jnp.float32)
    got, cold, warm = timed(lambda: symalg.contract_all_indices_with_vector(A, xj))
    rep.add(1, "eager, random symmetric", f"rank-{r} dim-{dd} f32",
            "dense einsum float64, relative",
            abs(float(got) - want) / want, TOL_F32, cold, warm)
    rep.add(1, "jit over A, random symmetric", f"rank-{r} dim-{dd} f32",
            "dense einsum float64, relative",
            abs(float(jit_eval(A, xj)) - want) / want, TOL_F32)


def phase2_batched(rep: Report, S: Sizes, seed: int = 1):
    """Batched evaluation with f32 and bf16 storage."""
    import symtensor_tpu as st
    from symtensor_tpu import symalg
    from symtensor_tpu.utils import combinatorics as comb
    from symtensor_tpu.utils.precision import value_prec

    r, d, B = S.batch_rank, S.batch_dim, S.batch
    n = comb.indep_size(r, d)
    rng = np.random.default_rng(seed)
    K = 4
    lam = rng.normal(size=K).astype(np.float32)
    vs = rng.normal(size=(K, d)).astype(np.float32)
    data = rank_one_sum(r, d, lam, vs)
    xs = rng.normal(size=(B, d)).astype(np.float32)
    want = rank_one_ref_batched(lam, vs, xs, r)
    xj = jnp.asarray(xs)
    size = f"rank-{r} dim-{d} n={n} B={B}"
    ref = "sum lam (v.x)^r float64, max|dy|/max|y|"

    A = st.FlatSymmetricTensor(rank=r, dim=d, data=data)
    got, cold, warm = timed(
        lambda: symalg.contract_all_indices_with_vector_batched(A, xj))
    rep.add(2, f"f32 storage, policy {value_prec(jnp.float32)}",
            size, ref, norm_err(got, want), TOL_BATCH_F32, cold, warm)

    A16 = A.astype(jnp.bfloat16)
    got, cold, warm = timed(
        lambda: symalg.contract_all_indices_with_vector_batched(A16, xj))
    rep.add(2, "bf16 storage (premultiplied views)", size, ref,
            norm_err(got, want), TOL_BF16, cold, warm)


def phase3_basis_change(rep: Report, S: Sizes, seed: int = 2):
    """Basis change: rank-4 whole-op route, rank-5 blocked recursion, and a
    small width against a dense float64 einsum."""
    import symtensor_tpu as st
    from symtensor_tpu import symalg
    from symtensor_tpu.ops.basis_change import basis_change_packed
    from symtensor_tpu.utils import combinatorics as comb

    rng = np.random.default_rng(seed)
    d = S.bc_dim
    # nonnegative W, v and x keep C·x^r free of cancellation (the dense
    # checks below use signed W)
    Wn = rng.uniform(0.0, 1.0, size=(d, d)) / d
    W = jnp.asarray(Wn, jnp.float32)
    K = 4
    for r, blocked in ((4, False), (5, True)):
        n = comb.indep_size(r, d)
        lam = rng.normal(size=K).astype(np.float32)
        vs = rng.uniform(0.0, 1.0, size=(K, d)).astype(np.float32)
        A = st.FlatSymmetricTensor(rank=r, dim=d,
                                   data=rank_one_sum(r, d, lam, vs))
        if blocked:
            fn = lambda: basis_change_packed(  # noqa: E731
                A, W, block_elems=S.bc_block_elems).data
            what = "basis_change_packed blocked recursion"
        else:
            fn = lambda: symalg.contract_all_indices_with_matrix(  # noqa: E731
                A, W).data
            what = "contract_all_indices_with_matrix (whole-op route)"
        Cd, cold, warm = timed(fn)
        C = st.FlatSymmetricTensor(rank=r, dim=d, data=Cd)
        x = rng.uniform(0.0, 1.0, size=d).astype(np.float32)
        # C = Σ lam (Wᵀv)^{⊗r}, so C·x^r = Σ lam (v·Wx)^r = A·(Wx)^r
        vW = np.asarray(vs, np.float64) @ np.asarray(W, np.float64)
        want, bound = rank_one_ref(lam, vW, x, r)
        lhs = float(symalg.contract_all_indices_with_vector(C, jnp.asarray(x)))
        rhs = float(symalg.contract_all_indices_with_vector(
            A, W @ jnp.asarray(x)))
        rep.add(3, what, f"rank-{r} dim-{d} f32 n={n}",
                "C.x^r vs sum lam (v.Wx)^r float64, error / bound",
                abs(lhs - want) / bound, TOL_F32, cold, warm,
                identity_err=abs(lhs - rhs) / bound)
        free(Cd, A.data, *getattr(A, "_group_views_premul", ()),
             *getattr(C, "_group_views_premul", ()))

    dd = S.small_dim
    for r in (4, 5):
        D = random_dense_symmetric(r, dd, rng)
        Wd = rng.normal(size=(dd, dd)) / np.sqrt(dd)
        A = st.FlatSymmetricTensor.from_dense(jnp.asarray(D, jnp.float32))
        Wj = jnp.asarray(Wd, jnp.float32)
        out, cold, warm = timed(
            lambda: symalg.contract_all_indices_with_matrix(A, Wj).data)
        want = D
        for _ in range(r):
            want = np.tensordot(want, Wd, axes=([0], [0]))
        got = np.asarray(
            st.FlatSymmetricTensor(rank=r, dim=dd, data=out).todense(),
            np.float64)
        rep.add(3, "contract_all_indices_with_matrix", f"rank-{r} dim-{dd} f32",
                "dense einsum float64, max|dC|/max|C|", norm_err(got, want),
                TOL_F32, cold, warm)


def _e_poly(x, k):
    """Elementary symmetric polynomials e_0..e_k of x (float64 DP)."""
    e = np.zeros(k + 1)
    e[0] = 1.0
    for v in np.asarray(x, np.float64):
        e[1:] = e[1:] + v * e[:-1]
    return e


def phase4_symalg(rep: Report, S: Sizes, seed: int = 3):
    """BASELINE.json C1, C3 and C4."""
    import symtensor_tpu as st
    from symtensor_tpu import symalg

    rng = np.random.default_rng(seed)

    # C1: symmetrized outer and tensordot, rank 3; symmetrization leaves
    # contraction with x^{⊗r} unchanged, so the dense references are
    # (A·x^3)(B·x^3) and Σ_i (A·x^2)_i (B·x^2)_i (nonnegative entries)
    d = S.c1_dim
    Da = np.abs(random_dense_symmetric(3, d, rng))
    Db = np.abs(random_dense_symmetric(3, d, rng))
    A = st.FlatSymmetricTensor.from_dense(jnp.asarray(Da, jnp.float32))
    B = st.FlatSymmetricTensor.from_dense(jnp.asarray(Db, jnp.float32))
    xs = rng.uniform(0.0, 1.0, size=(4, d))
    outer = lambda: symalg.multiply.outer(A, B).data  # noqa: E731
    tdot = lambda: symalg.tensordot(A, B, axes=1).data  # noqa: E731
    for what, fn, r_out, ref_fn in (
        ("multiply.outer", outer, 6,
         lambda x: dense_contract(Da, x) * dense_contract(Db, x)),
        ("tensordot(axes=1)", tdot, 4,
         lambda x: float(np.einsum("ijk,j,k->i", Da, x, x)
                         @ np.einsum("ijk,j,k->i", Db, x, x))),
    ):
        out, cold, warm = timed(fn)
        C = st.FlatSymmetricTensor(rank=r_out, dim=d, data=out)
        err = max(
            abs(float(symalg.contract_all_indices_with_vector(
                C, jnp.asarray(x, jnp.float32))) / ref_fn(x) - 1.0)
            for x in xs)
        rep.add(4, f"C1 {what}", f"rank-3 x rank-3 dim-{d} f32",
                "dense einsum float64 at 4 random x, relative",
                err, TOL_F32, cold, warm)

    # C3: scalar σ-classes at rank 6; closed form from elementary
    # symmetric polynomials: Σ over ordered index tuples of each class
    d = S.c3_dim
    A6 = st.PermClsSymmetricTensor(
        rank=6, dim=d, data={"iiiiii": 0.5, "iijjkk": -0.25, "ijklmn": 2.0})
    x = rng.uniform(0.0, 1.0, size=d)
    want = (0.5 * np.sum(x**6)
            - 0.25 * 90 * _e_poly(x**2, 3)[3]
            + 2.0 * math.factorial(6) * _e_poly(x, 6)[6])
    xj = jnp.asarray(x, jnp.float32)
    f_sc = jax.jit(lambda x: symalg.contract_all_indices_with_vector(A6, x))
    got, cold, warm = timed(lambda: f_sc(xj))
    rep.add(4, "C3 PermCls scalar classes", f"rank-6 dim-{d} f32",
            "elementary-symmetric closed form float64, relative",
            abs(float(got) - want) / abs(want), TOL_F32, cold, warm)

    # C4: contract_tensor_list over a list of dim rank-2 tensors
    # (benchmarks/run_configs.py, with nonnegative weights and factors):
    # chi_i = 0.1 (i+1) I, so B·x^4 = Σ_i (A·x^2)_i 0.1 (i+1) |x|^2
    d = S.c4_dim
    key = jax.random.PRNGKey(seed)
    w = jnp.abs(jax.random.normal(key, (4,)))
    F = jnp.abs(jax.random.normal(jax.random.PRNGKey(seed + 1), (4, d)))
    Ad = st.DecompSymmetricTensor(rank=3, dim=d, weights=w, factors=F,
                                  multiplicities=(3,))
    chis = [st.DecompSymmetricTensor.from_matrix(
        jnp.eye(d) * (i + 1) * 0.1, cutoff=0.0) for i in range(d)]
    res, cold, warm = timed(
        lambda: symalg.contract_tensor_list(Ad, chis, n_times=1))
    w64 = np.asarray(w, np.float64)
    F64 = np.asarray(F, np.float64)
    c = 0.1 * np.arange(1, d + 1)
    err = 0.0
    for x in rng.uniform(0.0, 1.0, size=(4, d)):
        Ax2 = (F64 * ((F64 @ x) ** 2 * w64)[:, None]).sum(0)  # A·x^2
        want = float(Ax2 @ c) * float(x @ x)
        got = float(symalg.contract_all_indices_with_vector(
            res, jnp.asarray(x, jnp.float32)))
        err = max(err, abs(got - want) / abs(want))
    rep.add(4, "C4 contract_tensor_list", f"decomp rank-3 dim-{d}, {d} chis",
            "dense closed form float64 at 4 random x, relative",
            err, TOL_F32, cold, warm)


def phase5_model(rep: Report, S: Sizes, seed: int = 4, steps: int = 3):
    """models.polynomial: jitted optax Adam steps through train_step."""
    import optax

    from symtensor_tpu import symalg
    from symtensor_tpu.models import polynomial

    d, B = S.model_dim, S.model_batch
    ranks = (2, 3, 4)
    params = polynomial.init(jax.random.PRNGKey(seed), ranks=ranks, dim=d)
    kx, ky = jax.random.split(jax.random.PRNGKey(seed + 1))
    xs = jax.random.normal(kx, (B, d)) / np.sqrt(d)
    ys = 0.1 * jax.random.normal(ky, (B,))
    opt = optax.adam(1e-5)
    opt_state = opt.init(params)
    step = jax.jit(lambda p, s, x, y: polynomial.train_step(p, s, x, y, opt))

    pred = params["bias"] + sum(
        symalg.contract_all_indices_with_vector_batched(t, xs)
        for t in params["terms"].values())
    want0 = float(jnp.mean((pred - ys) ** 2))

    losses = []
    t0 = time.perf_counter()
    params, opt_state, loss = jax.block_until_ready(
        step(params, opt_state, xs, ys))
    cold = time.perf_counter() - t0
    losses.append(float(loss))
    ts = []
    for _ in range(max(steps - 1, WARM_CALLS)):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, xs, ys))
        ts.append(time.perf_counter() - t0)
        losses.append(float(loss))
    finite = all(np.isfinite(losses))
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    rep.add(5, "train_step step-0 loss", f"ranks {ranks} dim-{d} B={B}",
            "batched public op on the same params, relative",
            abs(losses[0] - want0) / abs(want0), TOL_F32, cold,
            float(np.median(ts)), losses=losses)
    rep.add(5, "loss finite and falling", f"{len(losses)} Adam steps",
            "monotone decrease", 0.0 if finite and falls else float("inf"),
            0.0)


def four_cards(rep: Report, S: Sizes, seed: int = 5):
    """The sharded path on a four-device mesh, each result compared with the
    same op on one device in the same process."""
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import symtensor_tpu as st
    from symtensor_tpu import parallel, symalg
    from symtensor_tpu.kernels.poly_eval import poly_eval_flat_batched_fast
    from symtensor_tpu.models import polynomial
    from symtensor_tpu.ops.basis_change import basis_change_packed
    from symtensor_tpu.utils import combinatorics as comb

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, has "
                           f"{len(jax.devices())}")
    rng = np.random.default_rng(seed)
    mesh_tp = parallel.make_mesh((1, 4), ("dp", "tp"))

    def mem():
        out = {}
        for dv in jax.devices()[:4]:
            ms = dv.memory_stats() or {}
            out[str(dv.id)] = ms.get("bytes_in_use")
        return out

    # dp×tp polynomial train step (as __graft_entry__.dryrun_multichip)
    mesh = parallel.make_mesh((2, 2), ("dp", "tp"))
    d, Bm = S.model_dim, S.model_batch
    ranks = (2, 3)  # as __graft_entry__.dryrun_multichip
    params = polynomial.init(jax.random.PRNGKey(seed), ranks=ranks, dim=d)
    kx, ky = jax.random.split(jax.random.PRNGKey(seed + 1))
    xs = jax.random.normal(kx, (Bm, d)) / np.sqrt(d)
    ys = 0.1 * jax.random.normal(ky, (Bm,))
    opt = optax.adam(1e-5)

    def loss_sharded(p, x, y):
        out = p["bias"]
        for t in p["terms"].values():
            out = out + parallel.poly_eval_batched_sharded(t, x, mesh)
        return jnp.mean((out - y) ** 2)

    def make_step(loss):
        # Adam normalizes each coordinate's step, so a near-zero gradient
        # whose sign differs in the last bits moves its parameter by a
        # full learning rate: parameters after a few steps are no fair
        # comparison.  Compare the losses and the step-0 gradients.
        @jax.jit
        def step(p, s, x, y):
            loss_v, g = jax.value_and_grad(loss)(p, x, y)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s, loss_v, g

        return step

    step_sharded = make_step(loss_sharded)
    step_one = make_step(polynomial.loss_fn)
    xs_sh = jax.device_put(xs, NamedSharding(mesh, P("dp", None)))
    ys_sh = jax.device_put(ys, NamedSharding(mesh, P("dp")))
    p1, s1 = params, opt.init(params)
    p2, s2 = params, opt.init(params)
    l_one, l_sh = [], []
    t0 = time.perf_counter()
    for i in range(3):
        p1, s1, l1, g1 = step_one(p1, s1, xs, ys)
        p2, s2, l2, g2 = jax.block_until_ready(
            step_sharded(p2, s2, xs_sh, ys_sh))
        if i == 0:
            cold = time.perf_counter() - t0
            dgrad = max(
                norm_err(g2["terms"][k].data, g1["terms"][k].data)
                for k in g1["terms"])
        l_one.append(float(l1))
        l_sh.append(float(l2))
    mem_tr = mem()
    _, _, warm = timed(lambda: step_sharded(p2, s2, xs_sh, ys_sh))
    rep.add("_four", "dp x tp polynomial train step (2,2) mesh: losses",
            f"ranks {ranks} dim-{d} B={Bm}, 3 Adam steps",
            "same step on one device, relative",
            max(abs(a - b) / abs(b) for a, b in zip(l_sh, l_one)), TOL_F32,
            cold, warm, losses_sharded=l_sh, losses_one=l_one,
            bytes_in_use_per_device=mem_tr)
    rep.add("_four", "dp x tp train step: step-0 gradients", f"dim-{d}",
            "same step on one device, max|dg|/max|g|", dgrad, TOL_F32)

    # grouped sharded eval: every group's head axis over tp
    r, d, B = S.four_head_rank, S.four_head_dim, S.four_batch
    n = comb.indep_size(r, d)
    K = 4
    lam = rng.normal(size=K).astype(np.float32)
    vs = rng.normal(size=(K, d)).astype(np.float32)
    A = st.FlatSymmetricTensor(rank=r, dim=d, data=rank_one_sum(r, d, lam, vs))
    xs = jnp.asarray(rng.normal(size=(B, d)).astype(np.float32))
    views, cold_v, _ = timed(lambda: parallel.shard_group_views(A, mesh_tp),
                             warm=0)
    one = jax.block_until_ready(poly_eval_flat_batched_fast(A, xs))
    # the sharded views are now the only copy the eval needs (a view
    # placed on device 0 may share its buffer, so drop references only)
    free(A.data)
    object.__delattr__(A, "_group_views_premul")
    after_free = mem()
    got, cold, warm = timed(lambda: parallel.poly_eval_batched_sharded_grouped(
        A, xs, mesh_tp, views=views))
    want = rank_one_ref_batched(lam, vs, np.asarray(xs), r)
    rep.add("_four", "poly_eval_batched_sharded_grouped tp=4",
            f"rank-{r} dim-{d} f32 n={n} B={B}",
            "same op on one device, max|dy|/max|y|", norm_err(got, one),
            TOL_F32, cold, warm, err_vs_float64=norm_err(got, want),
            view_shard_s=cold_v, bytes_in_use_per_device=after_free,
            shards_per_view0=len(views[len(views) // 2].addressable_shards))
    free(*views)

    # column-sharded blocked basis change
    r, d = 4, S.four_bc_dim
    A = st.FlatSymmetricTensor(rank=r, dim=d, data=jnp.asarray(
        rng.normal(size=comb.indep_size(r, d)).astype(np.float32)))
    Q, _ = np.linalg.qr(rng.normal(size=(d, d)))
    W = jnp.asarray(Q, jnp.float32)
    Csh, cold, warm = timed(
        lambda: basis_change_packed(A, W, mesh=mesh_tp, tp_axis="tp").data)
    mem_bc = mem()
    C1 = basis_change_packed(A, W).data
    rep.add("_four", "basis_change_packed mesh tp=4", f"rank-{r} dim-{d} f32",
            "same op on one device, max|dC|/max|C|",
            norm_err(Csh, C1), TOL_F32, cold, warm,
            bytes_in_use_per_device=mem_bc)
    free(Csh, C1, A.data)

    # streamed tensordot, operands replicated and sharded
    d = S.four_td_dim
    A3 = st.FlatSymmetricTensor.from_dense(
        jnp.asarray(random_dense_symmetric(3, d, rng), jnp.float32))
    ref = symalg.tensordot(A3, A3, axes=1).data
    for mode in ("replicated", "sharded"):
        out, cold, warm = timed(lambda: parallel.tensordot_sharded(
            A3, A3, 1, mesh_tp, axis="tp", operands=mode).data)
        rep.add("_four", f"tensordot_sharded operands={mode} tp=4",
                f"rank-3 x rank-3 dim-{d} f32",
                "symalg.tensordot on one device, max|dC|/max|C|",
                norm_err(out, ref), TOL_F32, cold, warm,
                out_shards=len(out.addressable_shards) if hasattr(
                    out, "addressable_shards") else None)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (jax devices: {devices})",
              file=sys.stderr)
        return 3
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 3

    rep = Report()
    t_start = time.perf_counter()
    if args.four_cards:
        four_cards(rep, FULL)
    else:
        copy_rate, read_rate = phase0_device(rep, FULL)
        phase1_headline(rep, FULL, copy_rate, read_rate)
        phase2_batched(rep, FULL)
        phase3_basis_change(rep, FULL)
        phase4_symalg(rep, FULL)
        phase5_model(rep, FULL)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(card_line(), flush=True)
    if not rep.ok:
        print("chip_smoke: a check failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
