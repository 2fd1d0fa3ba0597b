"""Measure the production MSM wall-clock across sizes (one JSON line each).

Run on a GPU: python scripts/size_sweep.py [--sizes 12,14,16,18,20,22] [--verify]
Timing = dispatch-to-result single fetch (bench.py convention); every line
names the device (bench.device_fields, which refuses to run without a GPU
unless JAX_PLATFORMS=cpu is set on purpose).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="12,14,16,18,20,22")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--verify", action="store_true")
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from bench import device_fields
    from msm_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = device_fields()

    from msm_tpu.models import common
    from msm_tpu.models.cuzk import CHUNK_MAX, compute_msm_jpoint, cuzk_msm_point
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import pick_config

    for sz in [int(s) for s in args.sizes.split(",")]:
        n = 1 << sz
        cfg = pick_config(n)
        cv = Curve(cfg.curve)
        basep = [cv.to_affine(p) for p in cv.sample_points(256, seed=1)]
        pts = [basep[i % 256] for i in range(n)]
        rng = np.random.default_rng(2)
        ks = [
            int.from_bytes(rng.bytes(32), "little") % cfg.curve.order
            for _ in range(n)
        ]
        if n > CHUNK_MAX:  # host-chunked path: time compute_msm_jpoint
            compute_msm_jpoint(pts, ks, cfg)  # compile + warm
            t0 = time.time()
            res = compute_msm_jpoint(pts, ks, cfg)
            ms = (time.time() - t0) * 1e3  # includes per-chunk host prep
            ok = None
            if args.verify:
                from msm_tpu.oracle import best_msm

                ok = bool(cv.eq(res, best_msm(pts, ks, curve=cfg.curve)))
                assert ok, f"size 2^{sz} MISMATCH"
            print(json.dumps({"size": sz, "ms": ms, "chunked": True,
                              "verified": ok, **dev}), flush=True)
            continue
        x, y, s = common.pad_inputs(pts, ks, cfg)
        xd, yd, sd = jnp.asarray(x), jnp.asarray(y), jnp.asarray(s)
        geom = pick_geometry(x.shape[0], cfg.chunk_size)
        t0 = time.time()
        arr = np.asarray(cuzk_msm_point(xd, yd, sd, cfg, geom))
        compile_s = time.time() - t0
        times = []
        for _ in range(args.reps):
            t0 = time.time()
            arr = np.asarray(cuzk_msm_point(xd, yd, sd, cfg, geom))
            times.append(time.time() - t0)
        ms = min(times) * 1e3
        ok = None
        if args.verify:
            from msm_tpu.oracle import best_msm

            res = common.std_point_to_jpoint(arr, cfg)
            ok = bool(cv.eq(res, best_msm(pts, ks, curve=cfg.curve)))
            assert ok, f"size 2^{sz} MISMATCH"
        print(json.dumps({
            "size": sz, "ms": ms, "chunk": cfg.chunk_size,
            "compile_s": compile_s, "verified": ok, **dev,
        }), flush=True)


if __name__ == "__main__":
    main()
