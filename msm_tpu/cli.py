"""Command-line harness — the analogue of the reference's web
harness (``www/index.html`` + ``www/worker.js``): the reference exposes two
buttons (CPU MSM / WebGPU MSM) that sample inputs, run, and report
``[x, y, elapsed_ms]`` (``lib.rs:84-137``). Here:

    python -m msm_tpu msm    --size 16          # device MSM (run_webgpu_msm_web)
    python -m msm_tpu cpu    --size 12          # CPU oracle MSM (run_cpu_msm_web)
    python -m msm_tpu verify --size 12          # device vs oracle bit-exactness
    python -m msm_tpu bench  --size 20          # headline benchmark JSON
    python -m msm_tpu profile --size 16         # per-stage timing breakdown
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _sample(n: int, cfg, seed: int = 0):
    from bench import sample_inputs  # repo-root bench.py helpers

    return sample_inputs(n, cfg, seed=seed)


def _sample_lib(n: int, curve, seed: int = 0):
    """Library-only sampling (no repo-root dependency)."""
    import numpy as np

    from msm_tpu.oracle.pyecc import Curve

    cv = Curve(curve)
    nbase = min(n, 1024)
    base = [cv.to_affine(p) for p in cv.sample_points(nbase, seed=seed)]
    pts = [base[i % nbase] for i in range(n)]
    rng = np.random.default_rng(seed + 1)
    ks = [
        int.from_bytes(rng.bytes(32), "little") % curve.order for _ in range(n)
    ]
    return pts, ks


def cmd_msm(args) -> None:
    import msm_tpu

    cfg = msm_tpu.MsmConfig(
        curve=msm_tpu.CURVES[args.curve], glv=getattr(args, "glv", False)
    )
    n = 1 << args.size
    pts, ks = _sample_lib(n, cfg.curve, seed=args.seed)
    t0 = time.time()
    out = msm_tpu.run_tpu_msm(pts, ks, config=cfg)  # includes compile on 1st
    warm = time.time() - t0
    t0 = time.time()
    out = msm_tpu.run_tpu_msm(pts, ks, config=cfg)
    dt = time.time() - t0
    x, y = out if out is not None else (0, 0)
    print(json.dumps({"x": str(x), "y": str(y), "elapsed_ms": round(dt * 1e3, 2),
                      "first_run_ms": round(warm * 1e3, 2)}))


def cmd_cpu(args) -> None:
    import msm_tpu
    from msm_tpu.oracle.pyecc import Curve

    curve = msm_tpu.CURVES[args.curve]
    cv = Curve(curve)
    n = 1 << args.size
    pts, ks = _sample_lib(n, curve, seed=args.seed)
    t0 = time.time()
    res = msm_tpu.cpu_msm(pts, ks, curve=curve)
    dt = time.time() - t0
    x, y = cv.to_affine(res) if not res.is_identity() else (0, 0)
    print(json.dumps({"x": str(x), "y": str(y), "elapsed_ms": round(dt * 1e3, 2)}))


def cmd_verify(args) -> None:
    import msm_tpu
    from msm_tpu.oracle.pyecc import Curve

    curve = msm_tpu.CURVES[args.curve]
    cv = Curve(curve)
    cfg = msm_tpu.MsmConfig(curve=curve, glv=getattr(args, "glv", False))
    n = 1 << args.size
    pts, ks = _sample_lib(n, curve, seed=args.seed)
    got = msm_tpu.run_tpu_msm(pts, ks, config=cfg)
    want = msm_tpu.cpu_msm(pts, ks, curve=curve)
    ok = (got is None and want.is_identity()) or (
        not want.is_identity() and got == cv.to_affine(want)
    )
    print(json.dumps({"size": args.size, "curve": args.curve, "bit_exact": ok}))
    if not ok:
        sys.exit(1)


def cmd_bench(args) -> None:
    # bench.py opens the device itself: this process must not touch JAX
    # first (a second process on the card would find its memory taken)
    import subprocess
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cmd = [sys.executable, os.path.join(root, "bench.py"), "--size", str(args.size)]
    if args.verify:
        cmd.append("--verify")
    raise SystemExit(subprocess.call(cmd))


def cmd_variants(args) -> None:
    import msm_tpu
    from msm_tpu.utils.profiling import mont_variant_bench

    cfg = msm_tpu.MsmConfig(curve=msm_tpu.CURVES[args.curve])
    print(json.dumps(mont_variant_bench(cfg, batch=1 << args.size), indent=2))


def cmd_profile(args) -> None:
    from dataclasses import replace

    from msm_tpu.utils.profiling import stage_timings

    import msm_tpu

    cfg = msm_tpu.MsmConfig(curve=msm_tpu.CURVES[args.curve])
    cfg = replace(cfg, glv=getattr(args, "glv", False))
    report = stage_timings(1 << args.size, cfg)
    print(json.dumps(report, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="msm_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in [
        ("msm", cmd_msm),
        ("cpu", cmd_cpu),
        ("verify", cmd_verify),
        ("bench", cmd_bench),
        ("profile", cmd_profile),
        ("variants", cmd_variants),
    ]:
        p = sub.add_parser(name)
        p.add_argument("--size", type=int, default=16, help="log2 input size")
        p.add_argument("--curve", default="bn254")
        p.add_argument("--seed", type=int, default=0)
        if name in ("msm", "verify", "profile"):
            p.add_argument("--glv", action="store_true",
                           help="GLV endomorphism config (a=0 curves)")
        if name == "bench":
            p.add_argument("--verify", action="store_true")
        p.set_defaults(fn=fn)
    args = ap.parse_args(argv)
    if args.cmd not in ("bench", "cpu"):  # bench.py keeps its own cache
        from msm_tpu.utils.cache import enable_compile_cache

        enable_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
