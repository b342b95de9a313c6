"""Benchmark: contract_all_indices_with_vector, rank-6 dim-100 (BASELINE.json).

Prints ONE JSON line:
  {"metric": ..., "value": <effective dense GFLOP/s>, "unit": "GFLOP/s",
   "vs_baseline": <speedup vs dense einsum>}

Method
------
- The op runs on packed storage: n = C(105,6) = 1 609 344 100 independent
  components (float32, 6.4 GB in device memory) via the grouped-GEMV kernel
  (kernels/poly_eval.py). The dense tensor would be 100^6 = 1e12 elements
  (4 TB) — impossible to materialize, which is the point of the library.
- value: *effective dense* GFLOP/s — the FLOPs the dense einsum chain would
  need (Σ_k 2·d^k ≈ 2.02e12) divided by our measured wall time.
- vs_baseline: estimated dense-einsum time / our time. Dense throughput is
  measured on the largest feasible size (rank-6 dim-24, 0.76 GB) with the
  same tensordot chain and extrapolated at constant GFLOP/s — generous to
  the baseline, since the real 4 TB tensor could not even be resident.

Needs a GPU: without one it exits non-zero (no CPU fallback).  Env
overrides: SYMTENSOR_BENCH_RANK / _DIM / _REPEATS / _DTYPE.
"""

import json
import math
import os
import sys
import time

import numpy as np


def device_time(fn, repeats):
    """Median wall time of one call, each fenced with block_until_ready,
    after one warm-up call (compilation)."""
    import jax

    jax.block_until_ready(fn())  # compile + warm
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    import jax
    import jax.numpy as jnp

    import symtensor_tpu as st
    from symtensor_tpu import symalg
    from symtensor_tpu.ops.contract import _contract_vec_flat_simple

    import gc

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; jax devices: {jax.devices()}")

    rank = int(os.environ.get("SYMTENSOR_BENCH_RANK", 6))
    dim = int(os.environ.get("SYMTENSOR_BENCH_DIM", 100))
    repeats = int(os.environ.get("SYMTENSOR_BENCH_REPEATS", 5))
    dtype = jnp.dtype(os.environ.get("SYMTENSOR_BENCH_DTYPE", "float32"))

    n = st.utils.indep_size(rank, dim)
    key = jax.random.PRNGKey(0)

    # ---- dense baseline first (frees its memory before the big tensor) ----
    dense_flops = sum(2.0 * dim**k for k in range(1, rank + 1))
    d_base = int(os.environ.get("SYMTENSOR_BENCH_DENSE_DIM", 24))
    while d_base**rank * 4 > 2e9 and d_base > 4:
        d_base -= 2
    dense = jax.random.normal(key, (d_base,) * rank, jnp.float32)
    xb = jax.random.normal(jax.random.PRNGKey(3), (d_base,), jnp.float32)

    @jax.jit
    def dense_chain(dense, xb):
        out = dense
        for _ in range(rank):
            # full f32 like the packed path, not the GPU's TF32 default
            out = jnp.dot(out, xb, precision=jax.lax.Precision.HIGHEST)
        return out

    t_dense_small = device_time(lambda: dense_chain(dense, xb), repeats)
    dense_small_flops = sum(2.0 * d_base**k for k in range(1, rank + 1))
    dense_gflops = dense_small_flops / t_dense_small / 1e9
    t_dense_est = dense_flops / (dense_gflops * 1e9)
    del dense, xb
    gc.collect()

    # ---- the packed kernel at full size ----
    vals = jax.random.normal(key, (n,), dtype=dtype)
    A = st.FlatSymmetricTensor._raw(rank, dim, vals)
    x = jax.random.normal(jax.random.PRNGKey(1), (dim,), dtype=jnp.float32)

    # correctness sanity at a small size on the same code path
    dim_s = min(dim, 8)
    ns = st.utils.indep_size(rank, dim_s)
    As = st.FlatSymmetricTensor._raw(
        rank, dim_s, jax.random.normal(key, (ns,), jnp.float32)
    )
    xs = jax.random.normal(jax.random.PRNGKey(2), (dim_s,), jnp.float32)
    a = float(symalg.contract_all_indices_with_vector(As, xs))
    b = float(jax.jit(_contract_vec_flat_simple)(As, xs))
    rel = abs(a - b) / max(abs(b), 1e-30)
    assert rel < 1e-4, f"kernel self-check failed: {a} vs {b}"

    # our timing: the PUBLIC op — since round 4 it routes eager calls to
    # the views fast path (cached per-group matrices, cached jitted
    # evaluator — the intended repeated-evaluation usage)
    t_ours = device_time(
        lambda: symalg.contract_all_indices_with_vector(A, x), repeats
    )

    value = dense_flops / t_ours / 1e9
    vs_baseline = t_dense_est / t_ours

    print(
        json.dumps(
            {
                "metric": (
                    f"contract_all_indices_with_vector rank-{rank} dim-{dim} "
                    f"effective dense GFLOP/s (packed grouped-GEMV kernel, "
                    f"{dtype.name}, single chip)"
                ),
                "value": round(value, 2),
                "unit": "GFLOP/s",
                "vs_baseline": round(vs_baseline, 2),
                "detail": {
                    "n_components": n,
                    "time_ms": round(t_ours * 1e3, 3),
                    "dense_equiv_flops": dense_flops,
                    "dense_baseline_gflops_measured": round(dense_gflops, 2),
                    "dense_baseline_dim": d_base,
                    "dense_time_est_s": round(t_dense_est, 3),
                    "platform": jax.devices()[0].platform,
                    "device_kind": jax.devices()[0].device_kind,
                    "device_count": len(jax.devices()),
                    "kernel_selfcheck_relerr": rel,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
