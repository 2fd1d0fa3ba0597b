"""Smoke test of the MSM pipeline on one NVIDIA GPU (or four, on request).

    python chip_smoke.py               # one GPU: main path + timings
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One process drives the card(s). The run:

1. prints the card's name and power limit (nvidia-smi), ``jax.devices()``,
   ``device_kind`` and ``XLA_FLAGS``, and exits non-zero unless JAX's
   first device is a GPU;
2. drives the main path through the public entry points at the repo's
   headline size: ``run_tpu_msm`` on BN254 at 2^20 points, ``plan(points)``
   with two calls and a ``run_batch`` of four scalar sets, and
   ``run_tpu_msm`` on BLS12-381 at 2^16 — every result compared with the
   native C++ oracle by exact point equality;
3. prints cold (compile + run) and warm times of each call on earlier lines.

``--four-cards`` instead runs ``run_tpu_msm_sharded`` on BN254 at 2^22 over
a 4-device mesh, builds ``plan_sharded(points)`` and runs two calls plus
``run_batch``, and compares each result with the oracle and with the
one-card result. Its four large programs are compiled together first (one
thread each), so the calls load them from the persistent compile cache.

Inputs are made from ``--seed``: distinct points P_j + i*Q and uniform
scalars. Any failure raises; the last line of standard output is one JSON
object, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """`name, power.limit` of the first card, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _batch_inv(vals: list[int], p: int) -> list[int]:
    """Inverses mod p of nonzero vals with one pow (Montgomery's trick)."""
    pref = []
    acc = 1
    for v in vals:
        pref.append(acc)
        acc = acc * v % p
    inv = pow(acc, -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = pref[i] * inv % p
        inv = inv * vals[i] % p
    return out


def distinct_points(curve, n: int, seed: int,
                    chains: int = 256) -> list[tuple[int, int]]:
    """n affine points P_j + i*Q (the P_j and Q random from the seed), by
    chained affine additions in exact integers. The ``chains`` starts step
    together, so each step costs one batched inversion; the points are
    distinct unless some P_j - P_k is a small multiple of Q, which a random
    draw hits with negligible probability."""
    from msm_tpu.oracle.pyecc import Curve

    cv = Curve(curve)
    p = curve.modulus
    m = min(chains, n)
    drawn = [cv.to_affine(t) for t in cv.sample_points(m + 1, seed=seed)]
    qx, qy = drawn[0]
    cur = drawn[1:]
    out = list(cur)
    while len(out) < n:
        invs = _batch_inv([(qx - x) % p for x, _ in cur], p)
        nxt = []
        for (x, y), iv in zip(cur, invs):
            lam = (qy - y) * iv % p
            nx = (lam * lam - x - qx) % p
            nxt.append((nx, (lam * (x - nx) - y) % p))
        cur = nxt
        out.extend(cur)
    return out[:n]


def uniform_scalars(curve, n: int, seed: int) -> list[int]:
    import numpy as np

    raw = np.random.default_rng(seed).bytes(32 * n)
    return [
        int.from_bytes(raw[32 * i : 32 * i + 32], "little") % curve.order
        for i in range(n)
    ]


class Oracle:
    """The native C++ oracle only: at 2^20 the python oracle would not
    finish in useful time, so a missing native build is a failure."""

    def __init__(self):
        from msm_tpu.oracle.native import _lib_path, require_native
        from msm_tpu.params import BLS12_381, BN254

        for c in (BN254, BLS12_381):
            require_native(c)
        log(f"[oracle] native C++ oracle ({_lib_path()})")

    @staticmethod
    def affine(points, scalars, curve):
        from msm_tpu.oracle.native import native_msm
        from msm_tpu.oracle.pyecc import Curve

        cv = Curve(curve)
        res = native_msm([cv.from_affine(*pt) for pt in points], scalars,
                         curve)
        return None if res.is_identity() else cv.to_affine(res)


def check(name: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{name}: result differs from the oracle")
    log(f"[ok] {name} matches the C++ oracle")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def phase_main(oracle: Oracle, card: str, seed: int) -> None:
    import msm_tpu
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.params import BLS12_381, BN254

    n = 1 << 20
    t0 = time.perf_counter()
    pts = distinct_points(BN254, n, seed)
    kss = [uniform_scalars(BN254, n, seed + 1 + i) for i in range(4)]
    log(f"[setup] bn254 2^20 inputs in {time.perf_counter() - t0:.1f} s")
    want = [oracle.affine(pts, ks, BN254) for ks in kss]

    got, cold = timed(msm_tpu.run_tpu_msm, pts, kss[0])
    check("bn254 2^20 run_tpu_msm", got, want[0])
    got, warm = timed(msm_tpu.run_tpu_msm, pts, kss[0])
    check("bn254 2^20 run_tpu_msm (warm)", got, want[0])
    log(f"[time] bn254 2^20 run_tpu_msm: cold {cold:.3f} s, warm "
        f"{warm:.3f} s ({card})")

    plan, build = timed(msm_tpu.plan, pts)
    got, cold = timed(plan, kss[0])
    check("bn254 2^20 plan call 1", got, want[0])
    got, warm = timed(plan, kss[1])
    check("bn254 2^20 plan call 2", got, want[1])
    log(f"[time] bn254 2^20 plan: build {build:.3f} s, call cold "
        f"{cold:.3f} s, warm {warm:.3f} s ({card})")

    cv = Curve(BN254)
    batch = lambda: [cv.to_affine(r) for r in plan.run_batch(kss)]
    got, cold = timed(batch)
    for i in range(4):
        check(f"bn254 2^20 plan.run_batch instance {i}", got[i], want[i])
    got, warm = timed(batch)
    if got != want:
        raise AssertionError("bn254 2^20 plan.run_batch (warm) differs")
    log(f"[time] bn254 2^20 plan.run_batch x4: cold {cold:.3f} s, warm "
        f"{warm:.3f} s ({card})")

    m = 1 << 16
    pts381 = distinct_points(BLS12_381, m, seed + 7)
    ks381 = uniform_scalars(BLS12_381, m, seed + 8)
    want381 = oracle.affine(pts381, ks381, BLS12_381)
    run = lambda: msm_tpu.run_tpu_msm(
        pts381, ks381, config=msm_tpu.params.pick_config(m, BLS12_381)
    )
    got, cold = timed(run)
    check("bls12_381 2^16 run_tpu_msm", got, want381)
    got, warm = timed(run)
    check("bls12_381 2^16 run_tpu_msm (warm)", got, want381)
    log(f"[time] bls12_381 2^16 run_tpu_msm: cold {cold:.3f} s, warm "
        f"{warm:.3f} s ({card})")


def compile_four_card_programs(pts, ks, cfg, mesh, executor):
    """Compile the four large programs of the four-card phase at once.

    Each takes minutes to compile for the GPU, and XLA compiles without
    holding the GIL, so one thread each overlaps them. The arguments are
    built exactly as the entry points build theirs, so the entry points'
    first calls below load these programs from the persistent compilation
    cache. Returns the plan (built meanwhile on the main thread) and its
    build time."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import msm_tpu
    from msm_tpu.models import common, cuzk
    from msm_tpu.models.geometry import pick_geometry
    from msm_tpu.models.plan import _pack_scalar_words_host, scalars_to_words
    from msm_tpu.parallel import sharded, sharded_plan

    def compile_one(name, fn, *args):
        t0 = time.perf_counter()
        fn.lower(*args).compile()
        log(f"[compile] {name}: {time.perf_counter() - t0:.1f} s")

    d = mesh.devices.size
    axis = mesh.axis_names[0]
    rows = NamedSharding(mesh, P(axis, None))
    xs = common.pad_inputs(pts, ks, cfg, multiple=16 * d)
    n = xs[0].shape[0]
    jobs = [executor.submit(
        compile_one, "sharded one-shot", sharded.sharded_window_sums,
        *(jax.device_put(a, rows) for a in xs), cfg,
        pick_geometry(min(n // d, cuzk.SLICE), cfg.chunk_size), mesh, axis,
    )]
    x1 = common.pad_inputs(pts, ks, cfg)
    jobs.append(executor.submit(
        compile_one, "one-card one-shot", cuzk.cuzk_msm_point,
        *(jax.device_put(a) for a in x1), cfg,
        pick_geometry(x1[0].shape[0], cfg.chunk_size),
    ))
    splan, build = timed(msm_tpu.plan_sharded, pts, mesh, cfg)
    sp = _pack_scalar_words_host(scalars_to_words(ks, cfg, splan.n, splan.N))
    jobs.append(executor.submit(
        compile_one, "plan_sharded call", sharded_plan._sharded_plan_ws_std,
        splan._tables[0], jax.device_put(sp, rows), cfg, splan.geom, mesh,
        axis,
    ))
    batch = jax.device_put(np.stack([sp, sp]),
                           NamedSharding(mesh, P(None, axis, None)))
    jobs.append(executor.submit(
        compile_one, "plan_sharded run_batch x2",
        sharded_plan._sharded_plan_ws_std_batched, splan._tables[0], batch,
        cfg, splan.geom, mesh, axis,
    ))
    for job in jobs:
        job.result()
    return splan, build


def phase_four_cards(oracle: Oracle, card: str, seed: int,
                     log_n: int = 22) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import jax

    import msm_tpu
    from msm_tpu.oracle.pyecc import Curve
    from msm_tpu.parallel.sharded import default_mesh
    from msm_tpu.params import BN254, pick_config

    devs = jax.devices()
    if len(devs) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    mesh = default_mesh(devs[:4])
    n = 1 << log_n
    cfg = pick_config(n)
    t0 = time.perf_counter()
    pts = distinct_points(BN254, n, seed)
    kss = [uniform_scalars(BN254, n, seed + 1 + i) for i in range(2)]
    log(f"[setup] bn254 2^{log_n} inputs in {time.perf_counter() - t0:.1f} s")
    cv = Curve(BN254)

    # the oracle (C++ threads, GIL released) runs while XLA compiles
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as ex:
        wanted = ex.submit(
            lambda: [oracle.affine(pts, ks, BN254) for ks in kss])
        splan, build = compile_four_card_programs(pts, kss[0], cfg, mesh, ex)
        want = wanted.result()
    log(f"[compile] four programs compiled together (and the oracle run) "
        f"in {time.perf_counter() - t0:.1f} s")

    def sharded():
        res = msm_tpu.run_tpu_msm_sharded(pts, kss[0], config=cfg, mesh=mesh)
        return None if res.is_identity() else cv.to_affine(res)

    got, cold = timed(sharded)
    check(f"bn254 2^{log_n} run_tpu_msm_sharded (4 cards)", got, want[0])
    got, warm = timed(sharded)
    check(f"bn254 2^{log_n} run_tpu_msm_sharded (4 cards, warm)", got, want[0])
    log(f"[time] bn254 2^{log_n} run_tpu_msm_sharded x4: cold {cold:.3f} s, warm "
        f"{warm:.3f} s ({card})")

    one, t1 = timed(msm_tpu.run_tpu_msm, pts, kss[0], cfg)
    check(f"bn254 2^{log_n} run_tpu_msm (1 card)", one, want[0])
    if one != got:
        raise AssertionError("4-card result differs from the 1-card result")
    log(f"[ok] 4-card result equals the 1-card result; 1 card cold "
        f"{t1:.3f} s")

    got, cold = timed(splan, kss[0])
    check(f"bn254 2^{log_n} plan_sharded call 1", got, want[0])
    got, warm = timed(splan, kss[1])
    check(f"bn254 2^{log_n} plan_sharded call 2", got, want[1])
    res, tb = timed(splan.run_batch, kss)
    for i in range(2):
        check(f"bn254 2^{log_n} plan_sharded.run_batch instance {i}",
              cv.to_affine(res[i]), want[i])
    log(f"[time] bn254 2^{log_n} plan_sharded x4: build {build:.3f} s, call cold "
        f"{cold:.3f} s, warm {warm:.3f} s, run_batch x2 {tb:.3f} s ({card})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU sharded path and its checks")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import jax

    # the library first: outside a checkout this fails before any output
    from msm_tpu.utils.cache import enable_compile_cache

    devs = jax.devices()
    dev = devs[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is "
              f"{dev.platform} ({dev.device_kind})", file=sys.stderr)
        return 2
    card = card_line()
    log(f"[device] jax.devices() = {devs}")
    log(f"[device] device_kind = {dev.device_kind}")
    log(f"[device] XLA_FLAGS = {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[device] compile cache = {enable_compile_cache()}")
    oracle = Oracle()
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(oracle, card, args.seed)
    else:
        phase_main(oracle, card, args.seed)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devs)},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
