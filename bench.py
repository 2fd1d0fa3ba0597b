"""MSM wall-clock benchmark on one GPU (or a mesh of GPUs).

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...device}

Every line names the device it ran on (platform, device_kind, device count,
XLA_FLAGS, and the card's name and power limit from nvidia-smi). A run needs
a GPU and exits non-zero without one; the only exception is a CPU run asked
for explicitly with JAX_PLATFORMS=cpu (plumbing checks — its times are CPU
times, not device metrics).

The reference publishes no numbers (BASELINE.md), so ``vs_baseline`` is
computed against a documented estimate of the reference's class of result:
WebGPU cuZK MSM at 2^20 on a desktop GPU runs ~2 s wall-clock (the cuZK
paper's own V100 CUDA figure for 2^20 is ~0.1 s; browser WebGPU
implementations of this codebase's lineage report 1-3 s). We use
BASELINE_MS = 2000 and report speedup = baseline / ours.

Modes:
    (default)      one-shot cuzk_msm_point at 2^size
    --batched B    B independent instances in one device program
    --plan B       serving plan: table built once, B scalar sets
    --sharded D    scaling efficiency over D devices (needs >= D devices)
    --verify       cross-check the result against the C++ oracle
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MS = 2000.0  # documented estimate; see module docstring


def device_fields() -> dict:
    """The device a result was measured on; exits(2) unless it is a GPU or
    the caller explicitly asked for the CPU with JAX_PLATFORMS=cpu."""
    import jax

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        print(f"[bench] needs a GPU; JAX's first device is {dev.platform} "
              "(set JAX_PLATFORMS=cpu to run on the CPU on purpose)",
              file=sys.stderr)
        sys.exit(2)
    card_name = card_power_limit = None
    if dev.platform == "gpu":
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        card_name, card_power_limit = (s.strip() for s in line.rsplit(",", 1))
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(devs),
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
        "card_name": card_name,
        "card_power_limit": card_power_limit,
    }


def sample_inputs(n: int, cfg, seed: int = 0):
    """Benchmark inputs: 1024 distinct curve points tiled to n (point
    distinctness doesn't change MSM cost), uniform random scalars."""
    from msm_tpu.oracle.pyecc import Curve

    cv = Curve(cfg.curve)
    nbase = min(n, 1024)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    pts = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % cfg.curve.order
        for _ in range(n)
    ]
    return pts, ks


def _oracle_eq(res, pts, ks, cfg) -> bool:
    """Exact equality with the native C++ oracle; a failed native build is
    an error (the python oracle does not finish at benchmark sizes)."""
    from msm_tpu.oracle.native import native_msm, require_native
    from msm_tpu.oracle.pyecc import Curve

    require_native(cfg.curve)
    cv = Curve(cfg.curve)
    want = native_msm([cv.from_affine(*p) for p in pts], ks, cfg.curve)
    return cv.eq(res, want)


def bench_sharded(args) -> None:
    """Scaling-efficiency harness: field-muls/sec/device at D=1 vs D
    shards over real devices (fails when fewer than D exist)."""
    import jax
    import jax.numpy as jnp

    from msm_tpu.models import common
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.parallel.sharded import default_mesh, sharded_window_sums
    from msm_tpu.params import CURVES, pick_config

    D = args.sharded
    assert D & (D - 1) == 0, "shard count must be a power of two"
    multihost = bool(args.multihost)
    if multihost:
        # N-hosts row: join the jax.distributed runtime BEFORE any backend
        # touch (--cpu-devices sizes a CPU plumbing run)
        from msm_tpu.parallel.multihost import init_multihost

        if args.cpu_devices:
            jax.config.update("jax_num_cpu_devices", args.cpu_devices)
        init_multihost(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )
        assert D == len(jax.devices()), (
            f"--multihost measures the full global mesh: pass --sharded "
            f"{len(jax.devices())}"
        )
    dev = device_fields()
    if len(jax.devices()) < D:
        print(f"[bench] --sharded {D} needs {D} devices, found "
              f"{len(jax.devices())}", file=sys.stderr)
        sys.exit(2)
    n = 1 << args.size
    cfg = pick_config(n, curve=CURVES[args.curve])
    pts, ks = sample_inputs(n, cfg)
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, cfg, multiple=16 * D)
    muls = cfg.num_subtasks * n * 13  # scan madds x RCB16-alg8 mont-muls

    rows = []
    # multihost: a sub-mesh of one device would leave other processes
    # without addressable shards, so measure the full global mesh only
    for d in ([D] if multihost else sorted({1, D})):
        mesh = default_mesh(jax.devices()[:d])
        geom = pick_geometry(x_u16.shape[0] // d, cfg.chunk_size)
        if multihost:
            from msm_tpu.parallel.multihost import shard_global_inputs

            xd, yd, sd = shard_global_inputs(
                mesh, "data", x_u16, y_u16, s_u16
            )
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(mesh, P("data", None))
            xd, yd, sd = (
                jax.device_put(jnp.asarray(a), sh)
                for a in (x_u16, y_u16, s_u16)
            )
        ws = sharded_window_sums(xd, yd, sd, cfg, geom, mesh, "data")
        np.asarray(ws)  # compile + warm (fetch synchronizes)
        if args.verify:
            res = common.window_sums_to_result(np.asarray(ws), cfg)
            assert _oracle_eq(res, pts, ks, cfg), \
                f"sharded D={d} result does not match the oracle"
            print(f"[bench] D={d} verified vs the oracle", file=sys.stderr)
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            np.asarray(sharded_window_sums(xd, yd, sd, cfg, geom, mesh,
                                           "data"))
            times.append(time.perf_counter() - t0)
        t = min(times)
        rows.append({
            "shards": d,
            "wall_ms": t * 1e3,
            "field_muls_per_sec_per_device": muls / t / d,
        })
        print(f"[bench] D={d}: {t*1e3:.1f} ms", file=sys.stderr)
    plumbing_only = dev["platform"] == "cpu"
    if multihost:
        # one JSON line from process 0 only; efficiency vs 1 device is
        # computed offline against the single-host row of this command
        if jax.process_index() == 0:
            print(json.dumps({
                "metric": (f"{cfg.curve.name}_msm_2^{args.size}_multihost"
                           f"_{jax.process_count()}hosts_{D}devices"),
                "value": (None if plumbing_only
                          else rows[-1]["field_muls_per_sec_per_device"]),
                "unit": "field_muls_per_sec_per_device",
                "vs_baseline": None,
                "plumbing_only": plumbing_only,
                "detail": rows,
                **dev,
            }))
        return
    base = rows[0]["field_muls_per_sec_per_device"]
    eff = rows[-1]["field_muls_per_sec_per_device"] / base
    print(json.dumps({
        "metric": f"{cfg.curve.name}_msm_2^{args.size}_scaling_efficiency_{D}x",
        # a CPU run validates the sharded program + measurement plumbing
        # only, so its efficiency is never reported as a scaling result
        "value": None if plumbing_only else eff,
        "unit": "ops_per_sec_ratio",
        "vs_baseline": None if plumbing_only else eff / 0.8,
        "plumbing_only": plumbing_only,
        "detail": rows,
        **dev,
    }))


def bench_batched(args) -> None:
    """Batched-MSM throughput (BASELINE config 4: many independent 2^size
    instances in one device program)."""
    import jax

    from msm_tpu.models import common
    from msm_tpu.models.batched import batched_window_sums
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.params import CURVES, pick_config

    dev = device_fields()
    B = args.batched
    n = 1 << args.size
    cfg = pick_config(n, curve=CURVES[args.curve])
    pts, ks = sample_inputs(n, cfg)
    x, y, s = common.pad_inputs(pts, ks, cfg)
    # distinct scalars per instance (points shared is fine: cost-identical)
    xb = jax.device_put(np.broadcast_to(x, (B,) + x.shape))
    yb = jax.device_put(np.broadcast_to(y, (B,) + y.shape))
    sb = jax.device_put(np.stack([np.roll(s, i, axis=0) for i in range(B)]))
    geom = pick_geometry(x.shape[0], cfg.chunk_size)
    ws_np = np.asarray(batched_window_sums(xb, yb, sb, cfg, geom))
    if args.verify:
        # instance b pairs point j with scalar (j - b) mod n (np.roll),
        # which needs the unpadded size: pad_size floors at 16
        assert x.shape[0] == n, "batched --verify requires --size >= 4"
        for b in range(B):
            ks_b = [ks[(j - b) % n] for j in range(n)]
            res = common.window_sums_to_result(ws_np[b], cfg)
            assert _oracle_eq(res, pts, ks_b, cfg), (
                f"batched instance {b} does not match the oracle"
            )
        print(f"[bench] all {B} instances verified vs the oracle",
              file=sys.stderr)
    times = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        np.asarray(batched_window_sums(xb, yb, sb, cfg, geom))
        times.append(time.perf_counter() - t0)
    t = min(times)
    print(json.dumps({
        "metric": f"{cfg.curve.name}_batched_msm_{B}x2^{args.size}_per_instance",
        "value": t / B * 1e3,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / (t / B * 1e3),
        "verified": bool(args.verify),
        **dev,
    }))


def bench_plan(args) -> None:
    """Serving-plan throughput: build the plan ONCE (host serialize +
    device convert/pack of the point table), then run B scalar sets
    against the cached table — per-call latency with table reuse and
    run_batch ms/instance."""
    import msm_tpu
    from msm_tpu.models import common
    from msm_tpu.params import CURVES, pick_config

    dev = device_fields()
    B = args.plan
    n = 1 << args.size
    cfg = pick_config(n, curve=CURVES[args.curve])
    pts, ks = sample_inputs(n, cfg)
    t0 = time.perf_counter()
    plan = msm_tpu.plan(pts, config=cfg)
    print(f"[bench] plan build {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    # pre-packed scalar words: the serving fast path (a server receives
    # bytes, not python ints)
    s_words = [
        common.pad_scalars_words(
            [ks[(j - b) % n] for j in range(n)], cfg, plan.N
        )
        for b in range(B)
    ]
    got = plan.jpoint(s_words[0])  # compile + warm
    if args.verify:
        assert _oracle_eq(got, pts, ks, cfg), "plan result != oracle"
        print("[bench] plan verified vs the oracle", file=sys.stderr)
    times = []
    for r in range(args.reps):
        t0 = time.perf_counter()
        plan.jpoint(s_words[r % B])
        times.append(time.perf_counter() - t0)
    call_ms = min(times) * 1e3
    batch_ms = None
    if B > 1:
        res = plan.run_batch(s_words)  # compile + warm
        if args.verify:
            for b in range(B):
                ks_b = [ks[(j - b) % n] for j in range(n)]
                assert _oracle_eq(res[b], pts, ks_b, cfg), \
                    f"plan batch instance {b} does not match the oracle"
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            plan.run_batch(s_words)
            times.append(time.perf_counter() - t0)
        batch_ms = min(times) / B * 1e3
    best = min(call_ms, batch_ms) if batch_ms else call_ms
    print(json.dumps({
        "metric": f"{cfg.curve.name}_plan_msm_2^{args.size}_per_instance",
        "value": best,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / best,
        "call_ms": call_ms,
        "batch_ms_per_instance": batch_ms,
        "verified": bool(args.verify),
        **dev,
    }))


def bench_one_shot(args) -> None:
    import jax

    from msm_tpu.models import common
    from msm_tpu.models.cuzk import cuzk_msm_point
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.params import CURVES, MsmConfig, pick_config

    dev = device_fields()
    n = 1 << args.size
    curve = CURVES[args.curve]
    cfg = (MsmConfig(curve=curve, chunk_size=args.chunk) if args.chunk
           else pick_config(n, curve=curve))
    if args.glv:
        cfg = MsmConfig(curve=curve, chunk_size=cfg.chunk_size, glv=True)
    pts, ks = sample_inputs(n, cfg)
    x_u16, y_u16, s_u16 = common.pad_inputs(pts, ks, cfg)
    xd, yd, sd = (jax.device_put(a) for a in (x_u16, y_u16, s_u16))
    geom = pick_geometry(x_u16.shape[0], cfg.chunk_size)
    t0 = time.perf_counter()
    cuzk_msm_point(xd, yd, sd, cfg, geom).block_until_ready()
    print(f"[bench] compile + first run {time.perf_counter()-t0:.1f}s",
          file=sys.stderr)
    times = []
    for _ in range(args.reps):
        # one dispatch + one fetch of the 3L-limb result
        t0 = time.perf_counter()
        res = common.std_point_to_jpoint(
            np.asarray(cuzk_msm_point(xd, yd, sd, cfg, geom)), cfg
        )
        times.append(time.perf_counter() - t0)
    ms = min(times) * 1e3
    if args.verify:
        assert _oracle_eq(res, pts, ks, cfg), \
            "MSM result does not match the oracle"
        print("[bench] verified vs the oracle", file=sys.stderr)
    # nominal work: the non-GLV pipeline's madd muls (S windows x n x 13)
    s_nominal = MsmConfig(curve=curve, chunk_size=cfg.chunk_size).num_subtasks
    print(json.dumps({
        "metric": f"{curve.name}_msm_2^{args.size}_wall_clock",
        "value": ms,
        "unit": "ms",
        "vs_baseline": BASELINE_MS / ms,
        "config": "glv" if cfg.glv else "base",
        "chunk_size": cfg.chunk_size,
        "reps": args.reps,
        "verified": bool(args.verify),
        "field_muls_per_sec_nominal": s_nominal * n * 13 / (ms / 1e3),
        **dev,
    }))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=20)
    ap.add_argument("--curve", default="bn254",
                    help="curve name (bn254, bls12_377, bls12_381, pallas, "
                    "secp256k1, grumpkin, vesta)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="override window size (0 = config default)")
    ap.add_argument("--glv", action="store_true",
                    help="GLV endomorphism config")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--sharded", type=int, default=0, metavar="D",
                    help="scaling-efficiency mode over D devices")
    ap.add_argument("--multihost", action="store_true",
                    help="with --sharded: join jax.distributed first and "
                    "measure the full global mesh (run the SAME command in "
                    "every process)")
    ap.add_argument("--coordinator", help="with --multihost: host:port of "
                    "the jax.distributed coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    ap.add_argument("--cpu-devices", type=int, default=0,
                    help="with --multihost under JAX_PLATFORMS=cpu: virtual "
                    "CPU devices per process")
    ap.add_argument("--batched", type=int, default=0, metavar="B",
                    help="batched-MSM mode: B independent instances")
    ap.add_argument("--plan", type=int, default=0, metavar="B",
                    help="serving-plan mode: build the point table once, "
                    "run B scalar sets against it")
    args = ap.parse_args()

    from msm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    if args.sharded:
        bench_sharded(args)
    elif args.batched:
        bench_batched(args)
    elif args.plan:
        bench_plan(args)
    else:
        bench_one_shot(args)


if __name__ == "__main__":
    main()
