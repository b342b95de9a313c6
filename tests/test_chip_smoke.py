"""chip_smoke.py on the CPU: every phase function at tiny sizes, the
no-GPU exit, and the persistent compile-cache location."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def _run_phase(name):
    rep = cs.Report(out=sys.stdout)
    S = cs.SMALL
    if name == "phase0":
        copy_rate, read_rate = cs.phase0_device(rep, S)
        assert copy_rate > 0 and read_rate > 0
    elif name == "phase1":
        cs.phase1_headline(rep, S, 1e9, 1e9)
    elif name == "phase2":
        cs.phase2_batched(rep, S)
    elif name == "phase3":
        cs.phase3_basis_change(rep, S)
    elif name == "phase4":
        cs.phase4_symalg(rep, S)
    elif name == "phase5":
        cs.phase5_model(rep, S)
    elif name == "four_cards":
        cs.four_cards(rep, S)
    return rep


@pytest.mark.parametrize(
    "name",
    ["phase0", "phase1", "phase2", "phase3", "phase4", "phase5",
     "four_cards"],
)
def test_phase_passes_at_small_size(name):
    rep = _run_phase(name)
    assert rep.rows, "phase recorded no check"
    bad = [r for r in rep.rows if not r["ok"]]
    assert rep.ok and not bad, bad


def test_report_fails_on_tolerance_miss(capsys):
    rep = cs.Report(out=sys.stdout)
    assert rep.add(9, "x", "s", "r", 1e-3, 1e-4) is False
    assert rep.add(9, "y", "s", "r", float("nan"), 1.0) is False
    assert not rep.ok
    assert "phase9" in capsys.readouterr().out


@pytest.mark.parametrize("rank,dim", [(3, 4), (4, 5), (5, 4), (6, 3)])
def test_rank_one_sum_matches_dense(rank, dim):
    """The packed rank-one-sum builder agrees with from_dense of the
    explicit Σ lam v^{⊗r} (it is the full-width reference of phases 1-3)."""
    import symtensor_tpu as st

    rng = np.random.default_rng(rank * 10 + dim)
    lam = rng.normal(size=3)
    vs = rng.normal(size=(3, dim))
    dense = np.zeros((dim,) * rank)
    for l, v in zip(lam, vs):
        t = np.asarray(l)
        for _ in range(rank):
            t = np.multiply.outer(t, v)
        dense += t
    want = st.FlatSymmetricTensor.from_dense(jnp.asarray(dense)).data
    got = cs.rank_one_sum(rank, dim, lam, vs, dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def test_c3_closed_form_matches_dense():
    """The elementary-symmetric closed form used for C3 equals the dense
    contraction of the scalar-class tensor."""
    import symtensor_tpu as st

    d = 7
    A = st.PermClsSymmetricTensor(
        rank=6, dim=d, data={"iiiiii": 0.5, "iijjkk": -0.25, "ijklmn": 2.0},
        dtype=jnp.float64)
    x = np.random.default_rng(1).uniform(size=d)
    want = cs.dense_contract(np.asarray(A.todense()), x)
    got = (0.5 * np.sum(x**6) - 0.25 * 90 * cs._e_poly(x**2, 3)[3]
           + 2.0 * 720 * cs._e_poly(x, 6)[6])
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _env_cpu(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def test_exits_nonzero_without_gpu():
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        env=_env_cpu(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        env=_env_cpu(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_compile_cache_honours_env(tmp_path):
    cache = tmp_path / "cc"
    code = (
        "import jax, symtensor_tpu\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.jit(lambda v: v * 2 + 1)(jax.numpy.ones(3)).block_until_ready()\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT,
        env=_env_cpu(JAX_COMPILATION_CACHE_DIR=str(cache),
                     JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_compile_cache_default_is_checkout():
    code = (
        "import jax, symtensor_tpu\n"
        "from symtensor_tpu.config import DEFAULT_CACHE_DIR\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "print(DEFAULT_CACHE_DIR)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT,
        env=_env_cpu(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got, default = out.stdout.strip().splitlines()[-2:]
    assert got == default == str(ROOT / ".jax_cache")


def test_compile_cache_off_in_test_suite():
    from symtensor_tpu.config import enable_persistent_compile_cache

    assert not jax.config.jax_enable_compilation_cache
    assert enable_persistent_compile_cache() is None
