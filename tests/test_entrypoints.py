"""Entry-point contracts: the GPU smoke script refuses to run without a GPU,
the compile cache sits at a fixed path (or where JAX_COMPILATION_CACHE_DIR
says), and the native C++ oracle matches the pure-python oracle on every
curve it serves."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == ""  # no result line


def test_compile_cache_path():
    code = (
        "import jax; from msm_tpu.utils.cache import enable_compile_cache, "
        "DEFAULT_CACHE_DIR as d; p = enable_compile_cache(); "
        "print(p); print(d); print(jax.config.jax_compilation_cache_dir)"
    )
    base = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}

    def run(env):
        return subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env=env, cwd=ROOT, timeout=300, check=True,
        ).stdout.split()

    got, default, cfg = run(base)
    assert got == default == cfg == os.path.join(ROOT, ".jax_cache")
    got, _, cfg = run(dict(base, JAX_COMPILATION_CACHE_DIR="/tmp/elsewhere"))
    assert got == cfg == "/tmp/elsewhere"


def test_compile_cache_keeps_caller_config():
    """A directory set through jax.config before the library runs is kept,
    as is the caller's minimum compile time."""
    import jax

    from msm_tpu.utils.cache import enable_compile_cache

    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        jax.config.update("jax_compilation_cache_dir", "/tmp/callers_cache")
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 7.0)
        assert enable_compile_cache() == "/tmp/callers_cache"
        assert jax.config.jax_compilation_cache_dir == "/tmp/callers_cache"
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 7.0
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)


@pytest.mark.parametrize("curve_name", ["bn254", "bls12_381"])
def test_native_oracle_matches_python(curve_name):
    from msm_tpu.oracle.native import native_msm, require_native
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import CURVES

    spec = CURVES[curve_name]
    require_native(spec)
    cv = Curve(spec)
    pts = cv.sample_points(40, seed=3)
    ks = cv.sample_scalars(40, seed=4)
    ks[0], ks[1] = 0, spec.order - 1
    pts[2] = pts[3]  # duplicate point: the bucket doubling branch
    assert cv.eq(native_msm(pts, ks, spec), cv.msm_naive(pts, ks))
