"""Parity tests for the benchmarkable Montgomery-multiplier variants.

The reference ships several alternate multipliers swept over word sizes
13..16 (``src/cuzk/utils.rs:399-431``). The JAX analogues cover the full
menu (SURVEY §2.2): ``mont_mul_eager`` — uint32 eager-carry classic CIOS
(mont_pro_cios analogue); ``mont_mul_nsafe`` — nSafe-parameterized
grouped-carry product + plain wide reduce (mont_pro_modified +
mont_product/montgomery_reduce_2 analogues); the production lazy
multiplier is budget-limited to w=13 (bigint.check_overflow_budget).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from msm_tpu.ops.field import (
    mont_mul_eager,
    mont_mul_nsafe,
    mont_reduce_wide,
    mul_wide_nsafe,
    nsafe_for,
)
from msm_tpu.params import BN254, MsmConfig
from msm_tpu.utils.limbs import int_to_limbs, limbs_to_int


def _rand_field(rng, p):
    return int.from_bytes(rng.bytes(40), "little") % p


@pytest.mark.parametrize("w", [13, 14, 15, 16])
def test_mont_mul_eager_parity(w):
    cfg = MsmConfig(curve=BN254, word_size=w)
    p = BN254.modulus
    L = cfg.num_words
    R = 1 << (w * L)
    rinv = pow(R, -1, p)
    rng = np.random.default_rng(1000 + w)
    vals_a = [0, 1, p - 1, R % p] + [_rand_field(rng, p) for _ in range(28)]
    vals_b = [p - 1, 0, p - 1, R % p] + [_rand_field(rng, p) for _ in range(28)]
    a = jnp.asarray(
        np.stack([int_to_limbs(v, w, L) for v in vals_a]), jnp.int32
    )
    b = jnp.asarray(
        np.stack([int_to_limbs(v, w, L) for v in vals_b]), jnp.int32
    )
    out = np.asarray(mont_mul_eager(cfg, a, b))
    for i, (va, vb) in enumerate(zip(vals_a, vals_b)):
        want = va * vb * rinv % p
        got = limbs_to_int(out[i], w)
        assert got == want, (w, i, va, vb)
        # canonical-form contract: every limb in range, value < p
        assert got < p
        assert (out[i] >= 0).all() and (out[i] < (1 << w)).all()


def test_nsafe_values():
    assert nsafe_for(13) == 64
    assert nsafe_for(14) == 16
    assert nsafe_for(15) == 4
    assert nsafe_for(16) == 1


@pytest.mark.parametrize("w", [13, 14, 15, 16])
def test_mont_mul_nsafe_parity(w):
    """mont_pro_modified + montgomery_reduce_2 analogue: grouped-carry
    product and plain wide reduce, swept 13..16, vs python ints."""
    cfg = MsmConfig(curve=BN254, word_size=w)
    p = BN254.modulus
    L = cfg.num_words
    R = 1 << (w * L)
    rinv = pow(R, -1, p)
    rng = np.random.default_rng(2000 + w)
    vals_a = [0, 1, p - 1, R % p] + [_rand_field(rng, p) for _ in range(28)]
    vals_b = [p - 1, 0, p - 1, p - 2] + [_rand_field(rng, p) for _ in range(28)]
    a = jnp.asarray(
        np.stack([int_to_limbs(v, w, L) for v in vals_a]), jnp.int32
    )
    b = jnp.asarray(
        np.stack([int_to_limbs(v, w, L) for v in vals_b]), jnp.int32
    )
    # the wide product alone is exact
    prod = np.asarray(mul_wide_nsafe(cfg, a, b)).astype(np.int64)
    for i, (va, vb) in enumerate(zip(vals_a, vals_b)):
        assert limbs_to_int(prod[i], w) == va * vb, (w, i)
    # product + wide reduce = Montgomery product, canonical out
    out = np.asarray(mont_mul_nsafe(cfg, a, b))
    for i, (va, vb) in enumerate(zip(vals_a, vals_b)):
        want = va * vb * rinv % p
        got = limbs_to_int(out[i], w)
        assert got == want, (w, i, va, vb)
        assert got < p
        assert (out[i] >= 0).all() and (out[i] < (1 << w)).all()


def test_mont_reduce_wide_extremes():
    """T just under p*R (the reduce_2 bound) and tiny T reduce exactly."""
    cfg = MsmConfig(curve=BN254)
    w, L = cfg.word_size, cfg.num_words
    p = BN254.modulus
    R = 1 << (w * L)
    rinv = pow(R, -1, p)
    vals = [0, 1, p - 1, p * R - 1, (p - 1) * (p - 1), R, p * R - p]
    t = jnp.asarray(
        np.stack([int_to_limbs(v, w, 2 * L) for v in vals]), jnp.int32
    )
    out = np.asarray(mont_reduce_wide(cfg, t))
    for i, v in enumerate(vals):
        assert limbs_to_int(out[i], w) == v * rinv % p, (i, v)
