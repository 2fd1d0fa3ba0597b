"""Batched prime-field arithmetic in JAX: lazy-reduction Montgomery + Barrett.

Vectorized analogue of the reference's WGSL field libraries:
- field add/sub/reduce      (``src/cuzk/wgsl/field/field.template.wgsl:40-74``)
- Montgomery product        (``src/cuzk/wgsl/montgomery/mont_pro_product.template.wgsl``)
- Barrett multiply          (``src/cuzk/wgsl/field/barrett.template.wgsl``)

Where the reference bakes constants into shader source via Handlebars
(``shader_manager.rs:145-165``), ``FieldCtx`` closes over jnp constant arrays
derived from ``MsmConfig`` — jax.jit specializes each kernel per config, the
same way one WGSL instantiation exists per (field, limb-geometry) tuple.

**Representation (lazy / balanced).**
A field element is int32 [..., L] of word_size-bit limbs, little-endian,
where limbs may be slightly out of range (|limb| <~ 2^w + small, kept there
by single parallel carry-sweeps) and the integer VALUE is only guaranteed
congruent mod p within a small multiple of p (|value| <= ~10p), tracked by
static analysis of the curve formulas:

- ``add``/``sub``/``neg``: pure limbwise ops + one sweep — NO carry scans,
  NO conditional subtracts (the reference's field_add does a subtract-p
  branch per op, field.template.wgsl:40-55; here reduction is deferred
  entirely to the Montgomery multiply's bound).
- ``mont_mul``: loop-free Montgomery product (full column product, one
  truncated product for m, one for m*p, parallel sweeps between them) — a
  fixed handful of array ops that XLA fuses, with no limb loop. No final
  conditional subtract: for |x|,|y| <= c*p with c^2 <= few hundred the
  output satisfies |out| < (1 + eps + c^2 * p/R) * p (eps < 2^-9, from the
  masked m), so chains are self-stabilizing (requires R >= 64p, true for
  all supported configs; asserted).
- ``canonical``: exit-path full normalization (2 mont_muls squeeze the value
  into (-eps, 1+eps)p, then one carry scan + two conditional subtracts).
  Only results leaving the pipeline (or equality tests) pay for it.

Overflow safety: product columns of swept limbs stay below
L * (2^w + 128)^2 < 2^31 for every supported geometry (w=13, L <= 30);
validated by adversarial tests.

The pluggable alternate multiplier ``barrett_mul`` (canonical-form contract)
is kept for the reference's capability of benchmarkable multiplier variants
(SURVEY §2.2, "Montgomery variants").
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from msm_tpu.ops import bigint
from msm_tpu.params import MsmConfig
from msm_tpu.utils.limbs import int_to_limbs


class FieldCtx:
    """Field-arithmetic kernel family for one (curve, limb-geometry) config."""

    def __init__(self, cfg: MsmConfig):
        bigint.check_overflow_budget(cfg.word_size, cfg.num_words)
        self.cfg = cfg
        self.w = cfg.word_size
        self.L = cfg.num_words
        self.mask = cfg.mask
        p = cfg.curve.modulus
        # lazy-reduction soundness: mont output stays < 1.5p for inputs up to
        # ~8p only if R is comfortably above p
        assert (1 << (self.w * self.L)) >= 64 * p, "need R >= 64p for lazy reduction"

        def const(x: int, words: int | None = None) -> np.ndarray:
            # numpy (not jnp) so contexts are safe to build & cache inside
            # jit traces: np operands embed as constants, never tracers
            return int_to_limbs(x, self.w, words or self.L).astype(np.int32)

        self.p_limbs = const(p)
        self.r_limbs = const(cfg.r)  # R mod p == Montgomery form of 1
        self.r2_limbs = const(cfg.r2)
        self.rinv_limbs = const(cfg.rinv)
        self.one_limbs = const(1)
        self.zero_limbs = const(0)
        self.n0 = np.int32(cfg.n0)
        R = 1 << (self.w * self.L)
        self.nprime_limbs = const((-pow(p, -1, R)) % R)
        # top-limb renormalization fold:
        # the sweep keeps the top limb's overflow in place, so a mul output
        # can carry a +/-k*2^(w(L-1)+s) representation offset — value-exact
        # mod p but magnitude ~R, a fixed point of mont_mul that add chains
        # then amplify to int32 overflow. Folding k back as k*(2^.. mod p)
        # restores |value| <= ~32p at every mul exit.
        self.fold_s = max(0, p.bit_length() + 3 - self.w * (self.L - 1))
        assert self.fold_s < self.w, (self.fold_s, self.w, self.L)
        self.fold_c = const((1 << (self.w * (self.L - 1) + self.fold_s)) % p)
        # Barrett: mu = floor(4^k / p), k = bit length of p (params.gen_mu)
        self.k = cfg.curve.modulus_bits
        mu_words = -(-(self.k + 2) // self.w) + 1
        self.mu_limbs = const(cfg.mu, max(self.L + 1, mu_words))

    # -- lazy basic ops (balanced limbs, deferred reduction) -------------------

    def add(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """value(a) + value(b), exact (no mod) — one sweep, no scans."""
        return bigint.sweep(a + b, self.w)

    def sub(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """value(a) - value(b), exact — signed limbs allowed."""
        return bigint.sweep(a - b, self.w)

    def neg(self, a: jax.Array) -> jax.Array:
        """-value(a), exact (limbwise negate; bounds unchanged)."""
        return -a

    def double(self, a: jax.Array) -> jax.Array:
        return self.add(a, a)

    # -- Montgomery core: fused CIOS -------------------------------------------

    def mont_mul(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """Montgomery product a*b*R^-1 mod p on balanced representations.

        Loop-free separated-operand form (SOS): the full schoolbook column
        product T = a*b, then m = (T mod R) * (-p^-1) mod R and
        U = (T + m*p) / R — three column products, each one broadcast
        multiply + anti-diagonal sum, with parallel sweeps in between to
        keep every int32 column < 2^31 (L * (2^w + 128)^2 for the products
        of swept limbs). The low half of T + m*p is an exact multiple of R,
        so its carry into the high half is round(c_{L-1}/2^w +
        c_{L-2}/2^2w): the columns below L-2 move that sum by < 2^-8.

        |out| < (1 + eps + |a||b|/(p*R)) * p; see module docstring for
        the chain bound analysis. Output limbs are balanced (swept).
        """
        w, L, mask = self.w, self.L, self.mask
        batch = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = jnp.broadcast_to(a, batch + (L,))
        b = jnp.broadcast_to(b, batch + (L,))
        t = bigint.sweep(bigint.sweep(_product_columns(a, b), w), w)
        # m = T * (-p^-1) mod R: the low L swept limbs carry T mod R (up to
        # multiples of R); masking the top limb drops another multiple of R
        m = _product_columns(t[..., :L], self.nprime_limbs)[..., :L]
        m = bigint.sweep(bigint.sweep(m, w), w)
        m = m.at[..., L - 1].set(m[..., L - 1] & mask)
        c = t + _product_columns(m, self.p_limbs)  # [..., 2L-1]
        k = (c[..., L - 1] + ((c[..., L - 2] + (1 << (2 * w - 1))) >> w)) >> w
        out = jnp.concatenate(
            [c[..., L:], jnp.zeros_like(c[..., :1])], axis=-1
        ).at[..., 0].add(k)
        out = bigint.sweep(bigint.sweep(out, w), w)
        # top-limb renormalization: fold the swept top limb's excess k
        # back in as k * (2^(w(L-1)+s) mod p) — exact congruence; bounds
        # |value| <= ~32p so representation offsets cannot accumulate
        t = out[..., L - 1]
        k = t >> self.fold_s
        out = out.at[..., L - 1].add(-(k << self.fold_s))
        out = out + k[..., None] * self.fold_c
        return bigint.sweep(out, w)

    def mont_sqr(self, a: jax.Array) -> jax.Array:
        return self.mont_mul(a, a)

    def to_mont(self, a: jax.Array) -> jax.Array:
        """a -> a*R mod p (enter Montgomery form), via mont_mul with R^2 —
        the role of the reference's stage-1 field_mul-by-R conversion
        (decompose_scalars.template.wgsl:67-70)."""
        return self.mont_mul(a, self.r2_limbs)

    def from_mont(self, a: jax.Array) -> jax.Array:
        """a*R -> a (leave Montgomery form): mont_mul by 1 — the analogue of
        the host-side *rinv conversion (msm.rs:354-380), done on device."""
        return self.mont_mul(a, self.one_limbs)

    def mont_pow(self, a: jax.Array, e: int) -> jax.Array:
        """Montgomery exponentiation by a STATIC exponent (square-and-multiply
        as a lax.scan over MSB-first exponent bits; square always, multiply
        under select — mont_pro_product.template.wgsl:51-61 equivalent)."""
        acc = jnp.broadcast_to(self.r_limbs, a.shape)  # one in Montgomery form
        if e == 0:
            return acc
        bitstr = bin(e)[2:]
        if len(bitstr) <= 8:
            for bit in bitstr:
                acc = self.mont_sqr(acc)
                if bit == "1":
                    acc = self.mont_mul(acc, a)
            return acc
        bits = jnp.asarray([int(c) for c in bitstr], dtype=jnp.int32)

        def step(carry, bit):
            carry = self.mont_sqr(carry)
            withmul = self.mont_mul(carry, a)
            return jnp.where(bit > 0, withmul, carry), None

        acc, _ = jax.lax.scan(step, acc, bits)
        return acc

    # -- canonicalization (exit paths / equality only) --------------------------

    def canonical(self, a: jax.Array) -> jax.Array:
        """Balanced representation -> canonical limbs of (value mod p).

        Two mont_muls (by R^2 then 1) squeeze any |value| < ~100p into
        (-eps*p, (1+eps)*p); adding p and carry-scanning then needs at most
        two conditional subtracts (carry-aware for zero-slack moduli)."""
        w = self.w
        z = self.mont_mul(self.mont_mul(a, self.r2_limbs), self.one_limbs)
        v = z + self.p_limbs  # in (0, ~2.1p), nonneg
        limbs, carry = bigint.carry_propagate(v, w)
        for _ in range(2):
            d, borrow = bigint.sub(limbs, self.p_limbs + jnp.zeros_like(limbs), w)
            need = (carry > 0) | (borrow == 0)
            limbs = jnp.where(need[..., None], d, limbs)
            # a borrow that happened under a pending carry consumes it
            carry = jnp.where(need & (borrow == 1), carry - 1, carry)
        return limbs

    def is_zero(self, a: jax.Array) -> jax.Array:
        """value(a) ≡ 0 mod p (canonicalizes first)."""
        return jnp.all(self.canonical(a) == 0, axis=-1)

    def eq(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """value(a) ≡ value(b) mod p."""
        return self.is_zero(self.sub(a, b))

    # -- Barrett multiplier (alternate/pluggable variant; CANONICAL contract) ---

    def reduce(self, a: jax.Array) -> jax.Array:
        """Conditional subtract p for canonical values in [0, 2p) that fit L
        limbs (field_reduce, field.template.wgsl:47-55)."""
        d, borrow = bigint.sub(a, self.p_limbs + jnp.zeros_like(a), self.w)
        return jnp.where((borrow == 0)[..., None], d, a)

    def barrett_mul(self, a: jax.Array, b: jax.Array) -> jax.Array:
        """a*b mod p via Barrett reduction, canonical in / canonical out
        (barrett.template.wgsl:47-77): xh = x >> (k-1); l = xh*mu >> (k+1);
        r = x - l*p; up to two conditional subtracts."""
        w, L, k = self.w, self.L, self.k
        x = bigint.mul(a, b, w)  # [..., 2L] canonical
        xh = bigint.shr_bits(x, k - 1, w, L + 1)
        lm = bigint.mul(xh, jnp.broadcast_to(self.mu_limbs[: L + 1], xh.shape), w)
        l = bigint.shr_bits(lm, k + 1, w, L + 1)
        lp = bigint.mul(
            l,
            jnp.broadcast_to(
                jnp.concatenate([self.p_limbs, jnp.zeros(1, jnp.int32)]), l.shape
            ),
            w,
        )
        # full-width subtract (x >= l*p, difference < 3p), keep low L+1 limbs
        K = lp.shape[-1]
        xext = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (K - x.shape[-1],), x.dtype)], axis=-1
        )
        r, _ = bigint.sub(xext, lp, w)
        r = r[..., : L + 1]
        pext = jnp.concatenate([self.p_limbs, jnp.zeros(1, jnp.int32)])
        for _ in range(2):
            d, borrow = bigint.sub(r, pext + jnp.zeros_like(r), self.w)
            r = jnp.where((borrow == 0)[..., None], d, r)
        return r[..., :L]

    # -- inversion (exit paths / test use) --------------------------------------

    def inv_standard(self, a: jax.Array) -> jax.Array:
        """a^-1 mod p, canonical in/out, via Fermat (p-2 static exponent)."""
        am = self.to_mont(a)
        inv_m = self.mont_pow(am, self.cfg.curve.modulus - 2)
        return self.canonical(self.from_mont(inv_m))


def _product_columns(a: jax.Array, b: jax.Array) -> jax.Array:
    """Schoolbook product columns of limb vectors a [..., La] and b
    [..., Lb] -> [..., La+Lb-1] (no carries): one broadcast multiply, then
    the anti-diagonal sums by skewing row i right by i (pad each row to
    La+Lb, flatten, re-cut rows at width La+Lb-1) and summing the rows."""
    La, Lb = a.shape[-1], b.shape[-1]
    prod = a[..., :, None] * b[..., None, :]  # [..., La, Lb]
    batch = prod.shape[:-2]
    prod = jnp.pad(prod, [(0, 0)] * (prod.ndim - 1) + [(0, La)])
    flat = prod.reshape(batch + (La * (La + Lb),))[..., : La * (La + Lb - 1)]
    return flat.reshape(batch + (La, La + Lb - 1)).sum(axis=-2)


@functools.partial(jax.jit, static_argnames=("cfg",))
def mont_mul_eager(cfg: MsmConfig, a: jax.Array, b: jax.Array) -> jax.Array:
    """Classic CIOS Montgomery product in uint32 lanes with EAGER (per-step)
    carry normalization — the benchmarkable wide-word variant family.

    Where the production ``FieldCtx.mont_mul`` relies on the lazy 13-bit
    column budget (and ``check_overflow_budget`` rejects word_size >= 14),
    this variant normalizes the accumulator after every MAC so single
    products only need to fit uint32: it supports the reference's full
    sweepable word-size range 13..16 (``src/cuzk/utils.rs:399-431``) and
    plays the role of its classic-CIOS / nSafe-parameterized alternates
    (``mont_pro_cios.template.wgsl:30-101``,
    ``mont_pro_modified.template.wgsl:23-62``): a slower but
    wider-geometry multiplier kept for benchmarking (utils.profiling.
    mont_variant_bench sweeps it over word sizes).

    Contract: canonical limbs in (each < 2^word_size, value < p),
    canonical out. Budget (w <= 16): product (2^16-1)^2 + limb + carry
    < 2^32 in uint32 lanes; the eager scan keeps every column < 2^w
    between MACs.
    """
    w, L = cfg.word_size, cfg.num_words
    assert w <= 16, "uint32 eager CIOS supports word_size <= 16"
    umask = jnp.uint32(cfg.mask)
    n0 = jnp.uint32(cfg.n0)
    q = jnp.asarray(
        int_to_limbs(cfg.curve.modulus, w, L).astype(np.int64), jnp.uint32
    )
    batch = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    au = jnp.broadcast_to(a, batch + (L,)).astype(jnp.uint32)
    bu = jnp.broadcast_to(b, batch + (L,)).astype(jnp.uint32)
    xs = jnp.moveaxis(au, -1, 0)  # a-limbs, LSB first
    acc0 = jnp.zeros(batch + (L + 2,), jnp.uint32)

    def norm(acc):
        xm = jnp.moveaxis(acc, -1, 0)

        def stp(c, limb):
            v = limb + c
            return v >> w, v & umask

        _, limbs = jax.lax.scan(stp, jnp.zeros_like(xm[0]), xm)
        return jnp.moveaxis(limbs, 0, -1)

    def step(acc, a_i):
        acc = norm(acc.at[..., :L].add(a_i[..., None] * bu))
        m = (acc[..., 0] * n0) & umask
        acc = norm(acc.at[..., :L].add(m[..., None] * q))
        # low limb is exactly 0 now; shift the window down one limb
        return (
            jnp.concatenate(
                [acc[..., 1:], jnp.zeros_like(acc[..., :1])], axis=-1
            ),
            None,
        )

    acc, _ = jax.lax.scan(step, acc0, xs)
    out = acc[..., :L].astype(jnp.int32)
    # CIOS bound: out < 2p for canonical inputs — one conditional subtract
    qi = jnp.asarray(int_to_limbs(cfg.curve.modulus, w, L).astype(np.int32))
    d, borrow = bigint.sub(out, qi + jnp.zeros_like(out), w)
    return jnp.where((borrow == 0)[..., None], d, out)


def nsafe_for(word_size: int) -> int:
    """How many limb products fit a uint32 column before a carry
    normalization — the reference's nSafe parameter
    (``mont_pro_modified.template.wgsl:23-62`` computes the analogous
    count for its u32 accumulators; msm_tpu's production path instead
    proves a one-sweep budget for w=13, bigint.check_overflow_budget).
    w=13 -> 64 (never needed for L <= 33), 14 -> 16, 15 -> 4, 16 -> 1."""
    return max(1, ((1 << 32) - 1) // ((1 << word_size) - 1) ** 2)


def _u32_norm(acc: jax.Array, w: int) -> jax.Array:
    """Carry-normalize uint32 limb columns to < 2^w (top keeps overflow)."""
    umask = jnp.uint32((1 << w) - 1)
    xm = jnp.moveaxis(acc, -1, 0)

    def stp(c, limb):
        v = limb + c
        return v >> w, v & umask

    carry, limbs = jax.lax.scan(stp, jnp.zeros_like(xm[0]), xm)
    out = jnp.moveaxis(limbs, 0, -1)
    return out.at[..., -1].add(carry << w)


def mul_wide_nsafe(cfg: MsmConfig, a: jax.Array, b: jax.Array) -> jax.Array:
    """Full 2L-limb schoolbook product in uint32 lanes with carries
    normalized once every ``nsafe_for(w)`` accumulated products — the
    nSafe-parameterized product of the reference's mont_pro_modified
    (``mont_pro_modified.template.wgsl:23-62``), which omits carries for
    nSafe loop iterations then resolves them. Canonical limbs in,
    canonical 2L limbs out. Works for the full 13..16-bit sweep (w=16
    degenerates to eager per-step carries, nsafe=1)."""
    w, L = cfg.word_size, cfg.num_words
    ns = nsafe_for(w)
    batch = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    au = jnp.broadcast_to(a, batch + (L,)).astype(jnp.uint32)
    bu = jnp.broadcast_to(b, batch + (L,)).astype(jnp.uint32)
    acc = jnp.zeros(batch + (2 * L,), jnp.uint32)
    for g0 in range(0, L, ns):
        for i in range(g0, min(g0 + ns, L)):
            acc = acc.at[..., i : i + L].add(au[..., i : i + 1] * bu)
        acc = _u32_norm(acc, w)
    return acc


def mont_reduce_wide(cfg: MsmConfig, t: jax.Array) -> jax.Array:
    """Montgomery reduction of a full 2L-limb product: T -> T*R^-1 mod p —
    the reference's plain 512-bit reduce ``montgomery_reduce_2``
    (``mont_product.template.wgsl:4-54``), as a windowed uint32 scan.
    Canonical 2L limbs in (T < p*R), canonical L limbs out (< p)."""
    w, L = cfg.word_size, cfg.num_words
    umask = jnp.uint32(cfg.mask)
    n0 = jnp.uint32(cfg.n0)
    q = jnp.asarray(
        int_to_limbs(cfg.curve.modulus, w, L).astype(np.int64), jnp.uint32
    )
    assert t.shape[-1] == 2 * L, (t.shape, L)
    tu = t.astype(jnp.uint32)
    # sliding window of L+2 limbs starting at REDC step i; limbs above the
    # window enter from xs as the window shifts down
    acc0 = tu[..., : L + 2]
    hi = tu[..., L + 2 :]  # 2L - (L+2) = L-2 limbs
    pad = jnp.zeros(t.shape[:-1] + (2,), jnp.uint32)
    xs = jnp.moveaxis(jnp.concatenate([hi, pad], axis=-1), -1, 0)  # [L, ...]

    def step(acc, t_hi):
        m = (acc[..., 0] * n0) & umask
        acc = _u32_norm(acc.at[..., :L].add(m[..., None] * q), w)
        # acc[0] == 0 now; shift the window down one limb
        return jnp.concatenate([acc[..., 1:], t_hi[..., None]], axis=-1), None

    acc, _ = jax.lax.scan(step, acc0, xs)
    out = acc[..., :L].astype(jnp.int32)
    # bound: out < 2p — one conditional subtract (mont_product's tail)
    qi = jnp.asarray(int_to_limbs(cfg.curve.modulus, w, L).astype(np.int32))
    d, borrow = bigint.sub(out, qi + jnp.zeros_like(out), w)
    return jnp.where((borrow == 0)[..., None], d, out)


@functools.partial(jax.jit, static_argnames=("cfg",))
def mont_mul_nsafe(cfg: MsmConfig, a: jax.Array, b: jax.Array) -> jax.Array:
    """nSafe-parameterized Montgomery product: grouped-carry schoolbook
    product + plain wide reduce — the benchmarkable analogue of the
    reference's ``mont_pro_modified`` (nSafe carry omission) composed with
    ``montgomery_reduce_2`` (``mont_product.template.wgsl:4-54``).
    Canonical in/out; word sizes 13..16 (utils.rs:399-431 sweep)."""
    return mont_reduce_wide(cfg, mul_wide_nsafe(cfg, a, b))


@functools.lru_cache(maxsize=None)
def get_field_ctx(cfg: MsmConfig) -> FieldCtx:
    return FieldCtx(cfg)
