"""Config-space differential fuzzer: random (curve, n, chunk_size,
word_size, glv) pipelines vs the pure-python oracle.

The reference fuzzes only the input size on one fixed config
(``tests/test_webgpu_msm_cuzk_random.rs:11-15``); here the whole config
lattice is sampled, with adversarial scalar mixes (0, 1, order-1,
knife-edge GLV splits, duplicate and inverse points). Run on CPU:

    JAX_PLATFORMS=cpu python scripts/fuzz_e2e.py --seconds 3600 [--seed N]

Prints one line per trial; exits nonzero on the first mismatch with a
full repro line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1800)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from msm_tpu.models.cuzk import compute_msm_jpoint
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import CURVES, MsmConfig

    rng = np.random.default_rng(args.seed)
    deadline = time.time() + args.seconds
    trial = 0
    while time.time() < deadline:
        trial += 1
        if trial % 10 == 0:
            # every trial compiles fresh programs (unique config); the jit
            # caches otherwise accumulate until LLVM OOMs (~40 trials/125GB)
            jax.clear_caches()
        curve = CURVES[rng.choice(sorted(CURVES))]
        chunk = int(rng.choice([4, 8, 13, 16]))
        word_size = int(rng.choice([12, 13]))
        glv = bool(rng.integers(2))
        n = int(rng.integers(1, 200))
        cfg = MsmConfig(
            curve=curve, chunk_size=chunk, word_size=word_size, glv=glv
        )
        cv = Curve(curve)
        base = [cv.to_affine(p) for p in cv.sample_points(
            max(1, n // 2), seed=int(rng.integers(1 << 30)))]
        pts = [base[int(rng.integers(len(base)))] for _ in range(n)]
        r = curve.order
        specials = [0, 1, r - 1, r >> 1]
        if glv:
            from msm_tpu.ops.glv import glv_params

            g = glv_params(curve)
            for b in (g.v2[1], -g.v1[1]):
                m = int(rng.integers(0, 8))
                specials.append((((2 * m + 1) * r) // (2 * b)) % r)
        ks = [
            int(specials[int(rng.integers(len(specials)))])
            if rng.random() < 0.25
            else int.from_bytes(rng.bytes(32), "little") % r
            for _ in range(n)
        ]
        rec = dict(trial=trial, curve=curve.name, n=n, chunk=chunk,
                   w=word_size, glv=glv)
        t0 = time.time()
        try:
            got = compute_msm_jpoint(pts, ks, cfg)
        except Exception as e:
            print(json.dumps({**rec, "error": repr(e)[:300]}), flush=True)
            sys.exit(1)
        want = cv.msm_naive([cv.from_affine(*p) for p in pts], ks)
        ok = cv.eq(got, want)
        rec["s"] = round(time.time() - t0, 1)
        rec["ok"] = bool(ok)
        print(json.dumps(rec), flush=True)
        if not ok:
            print("MISMATCH — repro with the fields above", flush=True)
            sys.exit(1)
    print(f"fuzz clean: {trial} trials", flush=True)


if __name__ == "__main__":
    main()
