"""Profiling / tracing utilities — SURVEY §5's observability subsystem.

The reference instruments wall-clock only (``performance.now()`` around
sampling/MSM, ``lib.rs:89-98``; per-stage prints in native tests,
``tests/decompose_shader.rs:137-140``). Here:

- ``stage_timings(n, cfg)`` — per-stage device timings of the cuZK pipeline
  (decompose / sort / gather+scan / boundary / reduce / export) plus derived
  field-muls/sec — the roofline metric from BASELINE.md;
- ``trace(path)`` — context manager around ``jax.profiler`` for full XLA
  traces viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


@contextlib.contextmanager
def trace(path: str):
    """jax.profiler trace context (TensorBoard/Perfetto format)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _timeit(fn, *args, reps: int = 3) -> float:
    """Median wall-clock of a jitted callable, synchronized by fetching a
    scalar reduction of its outputs."""
    import jax
    import jax.numpy as jnp

    g = jax.jit(
        lambda *a: sum(jnp.sum(leaf) for leaf in jax.tree.leaves(fn(*a)))
    )
    float(g(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.time()
        float(g(*args))
        ts.append(time.time() - t0)
    return float(np.median(ts))


def stage_timings(n: int, cfg, seed: int = 0) -> dict:
    """Per-stage timings of the cuZK pipeline at size n (one subtask for the
    per-subtask stages, scaled in the report)."""
    import jax
    import jax.numpy as jnp

    from msm_tpu.models import common
    from msm_tpu.models.cuzk import cuzk_window_sums
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.ops.curve import get_curve_ctx, PointBatch
    from msm_tpu.ops.decompose import decompose_signed
    from msm_tpu.ops.scan import bucket_boundary_prefix, window_sum_from_pe
    from msm_tpu.oracle.pyecc import Curve

    ec = get_curve_ctx(cfg)
    cv = Curve(cfg.curve)
    nbase = min(n, 512)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    pts_a = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % cfg.curve.order
        for _ in range(n)
    ]
    x, y, s = common.pad_inputs(pts_a, ks, cfg)
    geom = pick_geometry(x.shape[0], cfg.chunk_size)
    xd, yd, sd = jnp.asarray(x), jnp.asarray(y), jnp.asarray(s)

    table = common.prepare_points(ec, xd, yd)
    if cfg.glv:
        from msm_tpu.ops.glv import decompose_signed_glv

        keys, signs = decompose_signed_glv(
            sd, cfg.chunk_size, cfg.num_subtasks, cfg
        )
    else:
        keys, signs = decompose_signed(sd, cfg.chunk_size, cfg.num_subtasks)
    k0, s0 = keys[0], signs[0]

    report: dict = {
        "n": n,
        "curve": cfg.curve.name,
        "num_subtasks": cfg.num_subtasks,
        "geometry": {
            "num_rows": geom.num_rows,
            "bpr_threads": geom.bpr_threads,
        },
        "stages_ms": {},
    }
    t = report["stages_ms"]
    t["convert_points"] = 1e3 * _timeit(
        lambda a, b: common.prepare_points(ec, a, b), xd, yd
    )
    if cfg.glv:
        # the GLV pipeline's real stage: device Babai split (incl. the
        # exact-rounding remainder correction) + per-half signed recode
        from msm_tpu.ops.glv import decompose_signed_glv

        t["decompose_scalars"] = 1e3 * _timeit(
            lambda a: decompose_signed_glv(
                a, cfg.chunk_size, cfg.num_subtasks, cfg
            ),
            sd,
        )
    else:
        t["decompose_scalars"] = 1e3 * _timeit(
            lambda a: decompose_signed(a, cfg.chunk_size, cfg.num_subtasks),
            sd,
        )
    t["boundary_prefix_per_subtask"] = 1e3 * _timeit(
        lambda k, sg, tab: bucket_boundary_prefix(
            ec, tab, k, cfg.num_buckets, geom.num_rows, signs=sg
        ),
        k0, s0, table,
    )
    pe = jax.jit(
        lambda k, sg, tab: bucket_boundary_prefix(
            ec, tab, k, cfg.num_buckets, geom.num_rows, signs=sg
        )
    )(k0, s0, table)
    S = cfg.num_subtasks
    pe16 = PointBatch(
        *(jnp.broadcast_to(a[None], (S,) + a.shape) for a in pe)
    )
    t[f"window_sum_x{S}_batched"] = 1e3 * _timeit(
        lambda b: jax.vmap(lambda p: window_sum_from_pe(ec, p))(b), pe16
    )
    t["full_pipeline"] = 1e3 * _timeit(
        lambda a, b, c: cuzk_window_sums(a, b, c, cfg, geom), xd, yd, sd
    )
    # NOMINAL work = the canonical (non-glv) pipeline's madd muls at this
    # chunk size — the same FLOPs-style convention bench.py uses, so glv
    # shows up as HIGHER effective throughput rather than a redefined
    # denominator
    nominal_subtasks = -(-(cfg.curve.order_bits + 1) // cfg.chunk_size)
    muls = nominal_subtasks * n * 13
    t_s = t["full_pipeline"] / 1e3
    report["field_muls_per_sec_nominal"] = round(muls / t_s)
    return report


def mont_variant_bench(cfg=None, batch: int = 1 << 16, reps: int = 5) -> dict:
    """Benchmark the pluggable field-multiplier variants — parity with the
    reference's benchmarkable Montgomery kernels (mont_pro_product /
    mont_pro_modified / mont_pro_cios / mont_product harnesses,
    ``src/cuzk/wgsl/montgomery/``; SURVEY §2.2):

    - ``mont_xla``      — loop-free Montgomery product (ops/field.py)
    - ``barrett_xla``   — Barrett multiply (canonical contract)
    - ``mont_eager_w{13..16}`` — uint32 eager-carry classic CIOS swept over
                          the reference's word-size range 13..16
                          (utils.rs:399-431; mont_pro_cios analogue)
    - ``mont_nsafe_w{13..16}`` — nSafe grouped-carry product + plain wide
                          reduce (mont_pro_modified + mont_product/
                          montgomery_reduce_2 analogues, ops/field.py)
    """
    import jax
    import jax.numpy as jnp

    from msm_tpu.ops.field import get_field_ctx
    from msm_tpu.params import DEFAULT_CONFIG

    cfg = cfg or DEFAULT_CONFIG
    f = get_field_ctx(cfg)
    rng = np.random.default_rng(0)

    def rand(shape):
        return jnp.asarray(
            rng.integers(0, cfg.mask, size=shape + (cfg.num_words,)),
            dtype=jnp.int32,
        )

    a, b = rand((batch,)), rand((batch,))
    out = {"batch": batch, "word_size": cfg.word_size, "num_words": cfg.num_words}
    out["mont_xla_ms"] = 1e3 * _timeit(f.mont_mul, a, b, reps=reps)
    ca, cb = f.canonical(a), f.canonical(b)
    out["barrett_xla_ms"] = 1e3 * _timeit(f.barrett_mul, ca, cb, reps=reps)
    # word-size sweep of the eager uint32 CIOS (reference sweeps 13..16)
    from dataclasses import replace

    from msm_tpu.ops.field import mont_mul_eager, mont_mul_nsafe

    for w in (13, 14, 15, 16):
        cw = replace(cfg, word_size=w)
        rngw = np.random.default_rng(w)
        aw = jnp.asarray(
            rngw.integers(0, (1 << w) - 1, size=(batch, cw.num_words)),
            dtype=jnp.int32,
        )
        bw = jnp.asarray(
            rngw.integers(0, (1 << w) - 1, size=(batch, cw.num_words)),
            dtype=jnp.int32,
        )
        out[f"mont_eager_w{w}_ms"] = 1e3 * _timeit(
            lambda x, y, c=cw: mont_mul_eager(c, x, y), aw, bw, reps=reps
        )
        out[f"mont_nsafe_w{w}_ms"] = 1e3 * _timeit(
            lambda x, y, c=cw: mont_mul_nsafe(c, x, y), aw, bw, reps=reps
        )
    return out
