#!/bin/sh
# Full CI gate (the "everything" tier).
#
# Tiers:
#   fast (default):  JAX_PLATFORMS=cpu python -m pytest tests/ -q -m 'not slow'
#       CPU backend with 8 virtual devices: the CUDA lowering gate for the
#       production programs, the scan-kernel parity tests, the XLA stage
#       tests, chunk-8 e2e across all seven curves, the sharded
#       compositions and the sliced/chunked branch tests. The compile
#       cache (.jax_cache, not committed) makes repeat runs faster.
#   full (this script): --runslow adds the frozen-feature sweeps (glv e2e +
#       device split), the 2-process multihost test and a bounded e2e
#       config fuzz, mirroring how the reference compiles every shader in
#       every GPU test (src/cuzk/gpu.rs:281-293).
#   gpu: on a GPU machine, python -m pytest tests/ -m gpu -q runs the
#       per-size end-to-end gates (tests/test_hw_e2e.py), and
#       python chip_smoke.py the main path at 2^20 against the C++ oracle.
#
# Usage: scripts/ci.sh
set -e
cd "$(dirname "$0")/.."
JAX_PLATFORMS=cpu python -m pytest tests/ -q --runslow
JAX_PLATFORMS=cpu python scripts/fuzz_e2e.py --seconds 120
