"""Flagship-size basis change on the GPU: rank-6 dim-100.

The reference cannot run this at all (its generic path materializes the
d^r = 1e12-element dense tensor, symalg.py:475-496); round 1 of this repo
capped out around rank 4-5 at dim 100 (full mixed-symmetry levels ~118 GB).
The blocked depth-first recursion (ops/basis_change.py) runs it on one device.

Storage dtype bfloat16 (tensor + blocks + output; 3.2 GB each at
n = C(105,6) = 1,609,344,100), accumulation float32.

Correctness at scale is checked on the device with the contraction identity
    C · x^{⊗r} = A · (W x)^{⊗r}
using the fast polynomial-evaluation kernel on both sides (bf16-level
agreement expected).  Small-size exactness vs the dense einsum oracle is
covered in tests/test_symalg.py (f64, 1e-11).

Usage:  python benchmarks/basis_change_flagship.py [rank dim]
"""

import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import symtensor_tpu as st
from symtensor_tpu import symalg
from symtensor_tpu.config import config
from symtensor_tpu.ops.basis_change import basis_change_packed
from symtensor_tpu.utils import combinatorics as comb


def main():
    rank = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    dim = int(sys.argv[2]) if len(sys.argv) > 2 else 100

    config.max_table_entries = 3_000_000_000
    n = comb.indep_size(rank, dim)
    # bf16 storage only where f32 residency (tensor + blocks + output)
    # would not fit the 16 GB device these settings were sized for; the
    # identity check is ~1e-6 in f32 instead of bf16-level ~1e-2
    sdt = jnp.bfloat16 if n > 200_000_000 else jnp.float32
    isz = jnp.dtype(sdt).itemsize
    print(f"rank={rank} dim={dim}: n = {n:,} "
          f"({isz*n/1e9:.1f} GB {jnp.dtype(sdt).name}), "
          f"device = {jax.devices()[0]}", flush=True)

    t0 = time.time()
    # generate in chunks INTO a donated buffer: peak = n + one chunk
    # (a single random.normal(n) spikes ~3x n: uint32 bits + output;
    # concatenating parts spiked 2x n and fragmented the arena)
    nchunk = 16
    csz = -(-n // nchunk)

    @partial(jax.jit, donate_argnums=(0,), static_argnums=(3,))
    def fill(buf, key, lo, m):
        chunk = jax.random.normal(key, (m,), sdt)
        return jax.lax.dynamic_update_slice(buf, chunk, (lo,))

    buf = jnp.zeros((n,), sdt)
    for i in range(nchunk):
        lo = i * csz
        m = min(csz, n - lo)
        if m > 0:
            buf = fill(buf, jax.random.PRNGKey(i), lo, m)
    A = st.FlatSymmetricTensor._raw(rank, dim, buf)
    del buf
    jax.block_until_ready(A.data)
    print(f"tensor materialized in {time.time()-t0:.1f}s", flush=True)

    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    W = jnp.asarray(Q, jnp.float32)

    kw = dict(
        store_dtype=sdt,
        # half of this goes to level-1 rows: R[1] ≈ elems/2/n_{r-1} sets
        # the number of full root gather passes (~8 at rank-6 dim-100).
        # Sized for a 16 GB device: blocks + one block-transpose
        # transient + tensor + output with two-pass headroom; not yet
        # re-decided for the GPU's 80 GB
        block_elems=int(os.environ.get(
            "SYMTENSOR_FLAGSHIP_BLOCK_ELEMS",
            1_900_000_000 if sdt == jnp.float32 else 2_000_000_000,
        )),
        transient_elems=int(os.environ.get(
            "SYMTENSOR_FLAGSHIP_TRANSIENT_ELEMS", 50_000_000
        )),
        # keep the 1.8 GB k=4 insert map off the device too — positions for
        # both k=5 and k=4 are ranked in-kernel from the (much smaller or
        # already-needed) representative tables
        onthefly_above=250_000_000,
    )

    # In the bf16 (big-n) regime, A + its 2-piece gather split + output +
    # level blocks don't all fit a 16 GB device: evaluate the identity RHS up
    # front, then let the basis change free A's buffer after the split
    # (observed OOM uploading a 17 MB table at level 1 otherwise)
    donate = sdt == jnp.bfloat16
    x = rhs = None
    if donate:
        x = jax.random.normal(jax.random.PRNGKey(1), (dim,), jnp.float32)
        rhs = float(symalg.contract_all_indices_with_vector(A, W @ x))
        kw["donate_root"] = True
        os.environ.setdefault("SYMTENSOR_FLAGSHIP_PASSES", "1")
        print("big-n mode: RHS evaluated up front, root donated, 1 pass",
              flush=True)

    def thr_stats():
        from symtensor_tpu.ops import basis_change as _bc

        thr = _bc._LAST_THROTTLE
        if thr is not None:
            return (f" [throttle: {thr.fences} fences / {thr.adds} "
                    f"dispatches, budget {thr.budget/1e9:.1f} GB]")
        return ""

    t0 = time.time()
    C = jax.block_until_ready(basis_change_packed(A, W, **kw))
    t_first = time.time() - t0
    t_warm = t_first
    print(f"basis change pass 1 (incl. compile): {t_first:.1f}s"
          + thr_stats(), flush=True)

    # pass 2 isolates compile time but doubles device time — skippable for
    # the multi-hour flagship size (SYMTENSOR_FLAGSHIP_PASSES=1)
    if (not donate
            and int(os.environ.get("SYMTENSOR_FLAGSHIP_PASSES", "2")) >= 2):
        C = None  # free pass-1 output: holding it OOMed the f32 rank-5 run
        t0 = time.time()
        C = jax.block_until_ready(basis_change_packed(A, W, **kw))
        t_warm = time.time() - t0
        print(f"basis change pass 2 (warm): {t_warm:.1f}s"
              + thr_stats(), flush=True)

    # on-device correctness identity: C·x^r == A·(Wx)^r
    if x is None:
        x = jax.random.normal(jax.random.PRNGKey(1), (dim,), jnp.float32)
    lhs = float(symalg.contract_all_indices_with_vector(C, x))
    if rhs is None:
        rhs = float(symalg.contract_all_indices_with_vector(A, W @ x))
    rel = abs(lhs - rhs) / max(abs(rhs), 1e-30)
    print(f"identity C·x^r vs A·(Wx)^r: lhs={lhs:.6g} rhs={rhs:.6g} "
          f"rel={rel:.3e}", flush=True)

    flops = 0
    for t in range(rank):
        flops += 2 * comb.multiset_count(dim, t + 1) * comb.indep_size(
            rank - t - 1, dim
        ) * dim
    print(f"useful FLOPs {flops/1e12:.2f} TF → "
          f"{flops/t_warm/1e12:.3f} TFLOP/s effective", flush=True)


if __name__ == "__main__":
    main()
