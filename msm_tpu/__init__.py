"""msm_tpu — a JAX multi-scalar multiplication (MSM) framework for GPUs.

Built from scratch in JAX/XLA with the capabilities of the
ICME-Lab/msm-webgpu reference (Rust/WebGPU cuZK MSM over BN254 G1):

- ``msm_tpu.params``      — curve/field/limb configuration (ShaderManager analogue)
- ``msm_tpu.ops``         — batched limb bigint, Montgomery/Barrett field,
                            branch-free Jacobian curve kernels
- ``msm_tpu.models``      — the cuZK pipeline and the naive Pippenger pipeline
- ``msm_tpu.parallel``    — multi-device sharded MSM (mesh + point-add collectives)
- ``msm_tpu.oracle``      — CPU oracles (pure-python + C++), halo2curves stand-in
- ``msm_tpu.utils``       — limb/byte serialization, compile cache

Public API mirrors the reference crate root (``src/lib.rs:20-137``):
``run_tpu_msm`` ~ ``run_webgpu_msm``; ``cpu_msm`` ~ ``cpu_msm``;
``sample_points`` / ``sample_scalars`` / ``*_to_bytes`` as in lib.rs:20-65.
"""

from msm_tpu.params import (
    BN254,
    BLS12_377,
    PALLAS,
    CURVES,
    DEFAULT_CONFIG,
    CurveSpec,
    MsmConfig,
)

__version__ = "0.1.0"

__all__ = [
    "BN254",
    "BLS12_377",
    "PALLAS",
    "CURVES",
    "DEFAULT_CONFIG",
    "CurveSpec",
    "MsmConfig",
    "cpu_msm",
    "plan",
    "plan_sharded",
    "run_tpu_msm",
    "run_tpu_msm_batched",
    "run_tpu_msm_sharded",
    "sample_points",
    "sample_scalars",
    "sample_32_bit_scalars",
    "scalars_to_bytes",
    "bytes_to_scalars",
    "points_to_bytes",
    "bytes_to_points",
]

from msm_tpu.utils.limbs import (  # noqa: E402  (reference lib.rs:50-65)
    bytes_to_points,
    bytes_to_scalars,
    points_to_bytes,
    scalars_to_bytes,
)


def _cache():
    from msm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()


def plan(points, config=None, validate=False):
    """Prepare an MSM plan over a fixed point set (SRS serving workload):
    the point table is serialized + device-converted ONCE; each
    ``plan(scalars)`` call runs only the scalar-side pipeline, and
    ``plan.run_batch([ks, ...])`` runs many scalar sets as one device
    program sharing the single cached table. The reference re-uploads and
    re-converts points on every call (``src/cuzk/msm.rs:75-417``)."""
    from msm_tpu.models.plan import MsmPlan

    _cache()
    return MsmPlan(points, config=config, validate=validate)


def plan_sharded(points, mesh=None, config=None, validate=False):
    """Multi-device serving plan: like ``plan`` but the cached point table
    is a SHARDED jax.Array over a device mesh (defaults to all devices) —
    each device converts and holds only its own point shard at build time,
    and every call runs the scalar-side pipeline compute-local per device
    with the KB-size all_gather + point-add-tree merge of the sharded path."""
    from msm_tpu.parallel.sharded_plan import ShardedMsmPlan

    _cache()
    return ShardedMsmPlan(points, mesh=mesh, config=config, validate=validate)


def run_tpu_msm_batched(instances, config=DEFAULT_CONFIG):
    """Many independent MSMs in one device program (prover workload).
    ``instances``: list of (points, scalars); returns oracle JPoints."""
    from msm_tpu.models.batched import compute_msm_batched

    _cache()
    return compute_msm_batched(instances, config)


def run_tpu_msm_sharded(points, scalars, config=DEFAULT_CONFIG, mesh=None):
    """Multi-device sharded MSM over a jax Mesh (defaults to all devices)."""
    from msm_tpu.parallel import compute_msm_sharded

    _cache()
    return compute_msm_sharded(points, scalars, config, mesh=mesh)


def cpu_msm(points, scalars, curve=BN254):
    """CPU oracle MSM (the reference's ``cpu_msm``, lib.rs:45-47).

    Uses the C++ native oracle when built, else the pure-python Pippenger.
    ``points``: list of (x, y) affine int pairs or oracle JPoints;
    ``scalars``: list of ints. Returns an oracle ``JPoint``.
    """
    from msm_tpu.oracle import best_msm

    return best_msm(points, scalars, curve=curve)


def run_tpu_msm(points, scalars, config=None, validate=False):
    """End-to-end device MSM (the reference's ``run_webgpu_msm``,
    lib.rs:76-82).

    ``points``: affine (x, y) int pairs; ``scalars``: ints.
    Returns the result as an affine (x, y) int pair (or None for identity).

    ``validate=True`` checks the input contract first (on-curve, and
    in-subgroup for cofactor>1 curves) and raises ``ValueError`` on
    violation — the guard the reference gets statically from halo2curves'
    typed points (``src/lib.rs:20-42``). Off by default: it costs ~1 us
    per point on-curve checking, plus one vectorized device [r]P ladder
    for cofactor>1 curves, and trusted callers skip it.
    """
    from msm_tpu.models.cuzk import compute_msm

    _cache()
    return compute_msm(points, scalars, config=config, validate=validate)


def sample_points(n: int, curve=BN254, seed: int = 0):
    """Random affine points (reference ``sample_points``, lib.rs:30-42)."""
    from msm_tpu.oracle.pyecc import Curve

    cv = Curve(curve)
    return [cv.to_affine(p) for p in cv.sample_points(n, seed=seed)]


def sample_scalars(n: int, curve=BN254, seed: int = 1):
    """Random scalars (reference ``sample_scalars``, lib.rs:20-28)."""
    from msm_tpu.oracle.pyecc import Curve

    return Curve(curve).sample_scalars(n, seed=seed)


def sample_32_bit_scalars(n: int, seed: int = 1):
    """Random scalars bounded below 2^32 (reference
    ``sample_32_bit_scalars``, lib.rs:25-33) — small-scalar inputs are a
    distinct edge-case class (all high windows hit bucket 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [int(v) for v in rng.integers(0, 1 << 32, size=n, dtype=np.uint64)]
