"""Measure the five BASELINE.json configs (+ a bf16 storage variant) on the
attached GPU.  Prints one JSON line; results are recorded in PERF.md.

Timing: median of several calls, each fenced with jax.block_until_ready,
after one warm-up call.  Without a GPU the script exits non-zero.
"""

import json
import time

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    import symtensor_tpu as st
    from symtensor_tpu import symalg
    from symtensor_tpu.kernels.poly_eval import poly_eval_flat_fast

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"run_configs.py needs a GPU; jax devices: {jax.devices()}")

    def dev_time(fn, K=5):
        jax.block_until_ready(fn())
        ts = []
        for _ in range(K):
            t0 = time.perf_counter()
            jax.block_until_ready(fn())
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    dev = jax.devices()[0]
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "device_count": len(jax.devices())}
    key = jax.random.PRNGKey(0)

    # config 1: rank-3 dim-30 symalg ops vs einsum-equivalent sizes
    r, d = 3, 30
    n = st.utils.indep_size(r, d)
    A = st.FlatSymmetricTensor._raw(r, d, jax.random.normal(key, (n,), jnp.float32))
    B = st.FlatSymmetricTensor._raw(r, d, jax.random.normal(key, (n,), jnp.float32))
    f_outer = jax.jit(lambda a, b: symalg.multiply.outer(a, b).data)
    t = dev_time(lambda: f_outer(A, B))
    out["c1_outer_r3xr3_d30_ms"] = round(t * 1e3, 3)
    f_td = jax.jit(lambda a, b: symalg.tensordot(a, b, axes=1).data)
    t = dev_time(lambda: f_td(A, B))
    out["c1_tensordot_ax1_ms"] = round(t * 1e3, 3)

    # config 2: rank-4 dim-100 basis change
    r, d = 4, 100
    n = st.utils.indep_size(r, d)
    A4 = st.FlatSymmetricTensor._raw(r, d, jax.random.normal(key, (n,), jnp.float32))
    W = jax.random.normal(key, (d, d), jnp.float32) / 10.0
    f_bc = jax.jit(lambda a, w: symalg.contract_all_indices_with_matrix(a, w).data)
    t = dev_time(lambda: f_bc(A4, W), K=3)
    out["c2_basis_change_r4_d100_ms"] = round(t * 1e3, 2)
    out["c2_packed_vs_dense_memory"] = round(d**r / n, 1)

    # config 3: rank-6 dim-200 permcls with scalar classes (too big to densify)
    A6 = st.PermClsSymmetricTensor(
        rank=6, dim=200, data={"iiiiii": 0.5, "iijjkk": -0.25, "ijklmn": 2.0}
    )
    x200 = jax.random.normal(key, (200,), jnp.float32)
    f_sc = jax.jit(lambda x: symalg.contract_all_indices_with_vector(A6, x))
    t = dev_time(lambda: f_sc(x200))
    out["c3_scalar_class_eval_r6_d200_ms"] = round(t * 1e3, 3)

    # config 4: decomp contract_tensor_list over a 5-tensor moment hierarchy
    dim = 64
    Ad = st.DecompSymmetricTensor(
        rank=3, dim=dim,
        weights=jax.random.normal(key, (4,)),
        factors=jax.random.normal(key, (4, dim)),
        multiplicities=(3,),
    )
    chis = [
        st.DecompSymmetricTensor.from_matrix(
            jnp.eye(dim) * (i + 1) * 0.1, cutoff=0.0
        )
        for i in range(dim)
    ]
    t0 = time.perf_counter()
    jax.block_until_ready(symalg.contract_tensor_list(Ad, chis, n_times=1))
    out["c4_contract_tensor_list_64list_rank2_n1_first_call_s"] = round(
        time.perf_counter() - t0, 2
    )
    t = dev_time(lambda: symalg.contract_tensor_list(Ad, chis, n_times=1))
    out["c4_contract_tensor_list_warm_ms"] = round(t * 1e3, 3)

    # config 5 (stretch): batched eval, 1024 inputs, rank-4 dim-100
    xs = jax.random.normal(key, (1024, d), jnp.float32)
    f_b = jax.jit(
        lambda xs: symalg.contract_all_indices_with_vector_batched(A4, xs)
    )
    t = dev_time(lambda: f_b(xs), K=3)
    out["c5_batched1024_r4_d100_ms"] = round(t * 1e3, 2)
    flops = 2.0 * n * 1024
    out["c5_packed_gemm_tflops"] = round(flops / t / 1e12, 2)

    # headline op bf16 variant: rank-6 dim-100
    r, d = 6, 100
    n = st.utils.indep_size(r, d)
    vals16 = jax.random.normal(key, (n,), jnp.bfloat16)
    A16 = st.FlatSymmetricTensor._raw(r, d, vals16)
    x = jax.random.normal(key, (d,), jnp.float32)
    t = dev_time(lambda: poly_eval_flat_fast(A16, x), K=5)
    out["headline_bf16_eval_r6_d100_ms"] = round(t * 1e3, 2)
    out["headline_bf16_effective_tflops"] = round(
        sum(2.0 * d**k for k in range(1, r + 1)) / t / 1e12, 1
    )

    print(json.dumps(out))


if __name__ == "__main__":
    main()
