"""Multi-device sharded MSM tests on the 8-virtual-device CPU mesh.

The analogue of the reference's "test parallelism without parallel
hardware" pattern (CPU models simulating thread decomposition,
``src/cuzk/test/utils.rs``): conftest forces 8 host devices, the sharded
pipeline runs with real shard_map + collectives.
"""

import jax
import numpy as np
import pytest

from msm_tpu.oracle.pyecc import Curve
from msm_tpu.params import BN254, MsmConfig
from msm_tpu.parallel import compute_msm_sharded, default_mesh

# chunk_size=8 keeps the compiled programs small (the collectives and the
# shard/merge logic under test are window-size independent); the production
# window size is exercised on the single-chip path in test_msm_e2e.py
CFG = MsmConfig(curve=BN254, chunk_size=8)
CV = Curve(BN254)


def _sample(n, seed=0):
    pts_j = CV.sample_points(n, seed=seed)
    pts = [CV.to_affine(p) for p in pts_j]
    ks = CV.sample_scalars(n, seed=seed + 1)
    return pts, ks


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_msm_matches_oracle(ndev):
    if len(jax.devices()) < ndev:
        pytest.skip(f"needs {ndev} devices")
    mesh = default_mesh(jax.devices()[:ndev])
    n = 257  # non-pow2, forces padding across shards
    pts, ks = _sample(n, seed=3)
    got = compute_msm_sharded(pts, ks, CFG, mesh=mesh)
    want = CV.msm([CV.from_affine(*p) for p in pts], ks)
    assert CV.eq(got, want)


def test_sharded_matches_single_chip():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from msm_tpu.models.cuzk import compute_msm_jpoint

    mesh = default_mesh(jax.devices()[:4])
    pts, ks = _sample(100, seed=7)
    a = compute_msm_sharded(pts, ks, CFG, mesh=mesh)
    b = compute_msm_jpoint(pts, ks, CFG)
    assert CV.eq(a, b)


def test_sharded_fused_kernels_interpret():
    """shard_map x the production scan at a multi-step geometry: the
    packed-table convert, the packed-row gather, the C = 4-step mixed-add
    scan, the lane offsets and the telescoped reduction execute INSIDE
    shard_map on the CPU mesh (1024 points per shard, 256 scan lanes),
    vs the oracle. Multi-device GPU runs compose exactly these two
    mechanisms."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from msm_tpu.models.geometry import MsmGeometry
    from msm_tpu.oracle import best_msm

    mesh = default_mesh(jax.devices()[:2])
    geom = MsmGeometry(num_rows=256, bpr_threads=64, subtask_batch=4)
    n = 2048
    base = [CV.to_affine(p) for p in CV.sample_points(32, seed=11)]
    pts = [base[i % len(base)] for i in range(n)]
    rng = np.random.default_rng(12)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BN254.order
        for _ in range(n)
    ]
    got = compute_msm_sharded(pts, ks, CFG, mesh=mesh, geometry=geom)
    assert CV.eq(got, best_msm(pts, ks))


@pytest.mark.slow
def test_sharded_glv_composition():
    """shard_map x GLV: the triple-row packed table and the phi-bit
    selection compose with shard_map exactly like on a multi-device mesh.
    CPU mesh, vs oracle."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 devices")
    from msm_tpu.models.geometry import MsmGeometry
    from msm_tpu.oracle import best_msm

    mesh = default_mesh(jax.devices()[:2])
    geom = MsmGeometry(num_rows=256, bpr_threads=64, subtask_batch=4)
    cfg = MsmConfig(curve=BN254, chunk_size=8, glv=True)
    n = 4096
    base = [CV.to_affine(p) for p in CV.sample_points(32, seed=21)]
    pts = [base[i % len(base)] for i in range(n)]
    rng = np.random.default_rng(22)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % BN254.order
        for _ in range(n)
    ]
    got = compute_msm_sharded(pts, ks, cfg, mesh=mesh, geometry=geom)
    assert CV.eq(got, best_msm(pts, ks))


def test_sharded_sliced_composition(monkeypatch):
    """Sharded x sliced (VERDICT r4 item 7): a shard larger than SLICE
    slices INSIDE the shard_map program (_window_sums_all composition).
    Production trigger: per-shard n > 2^20; shrunk so each of 4 shards
    runs 2 slices. Oracle-verified on the CPU mesh."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from msm_tpu.models import cuzk as cuzk_mod
    from msm_tpu.oracle import best_msm

    monkeypatch.setattr(cuzk_mod, "SLICE", 128)
    mesh = default_mesh(jax.devices()[:4])
    n = 1024  # 256/shard = 2 slices of 128
    pts, ks = _sample(n, seed=31)
    got = compute_msm_sharded(pts, ks, CFG, mesh=mesh)
    assert CV.eq(got, best_msm(pts, ks))


def test_sharded_chunked_composition(monkeypatch):
    """Sharded x chunked (VERDICT r4 item 7): per-shard n > CHUNK_MAX runs
    host-level chunks of d*CHUNK_MAX global points, each sharded+sliced,
    merged in exact ints. Shrunk: 2048 points over 4 shards with
    CHUNK_MAX=256, SLICE=128 -> 2 host chunks x (4 shards x 2 slices)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    from msm_tpu.models import cuzk as cuzk_mod
    from msm_tpu.oracle import best_msm

    monkeypatch.setattr(cuzk_mod, "SLICE", 128)
    monkeypatch.setattr(cuzk_mod, "CHUNK_MAX", 256)
    mesh = default_mesh(jax.devices()[:4])
    n = 2048
    pts, ks = _sample(n, seed=32)
    got = compute_msm_sharded(pts, ks, CFG, mesh=mesh)
    assert CV.eq(got, best_msm(pts, ks))
