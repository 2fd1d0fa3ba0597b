"""Curve / field / limb-geometry parameters for the MSM framework.

This is the analogue of the reference's configuration layer:

- compile-time constants ``WORD_SIZE`` / ``P`` / ``PARAMS``
  (reference: ``src/cuzk/msm.rs:34-46``),
- Montgomery parameter derivation — egcd, ``rinv``/``n0``, Barrett ``mu``
  (reference: ``src/cuzk/utils.rs:261-373``, ``calc_rinv_and_n0`` at
  ``utils.rs:339-348``, ``gen_mu`` at ``utils.rs:261-270``),
- limb-count rule ``num_words = ceil(bits / word_size)``
  (reference: ``src/cuzk/msm.rs:24-31``).

Unlike the reference — which bakes constants into WGSL shader source via
Handlebars templating (``src/cuzk/shader_manager.rs:145-165``) — here the
config is a frozen dataclass whose derived values are closed over by jitted
kernel factories; ``jax.jit`` plays the role of the shader compiler.

Everything is parameterized by the curve from day one (the reference supports
BN254 in the cuZK path and BN254+Pallas in the naive path; we ship BN254 and
BLS12-377 parameter sets).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Curve specifications (python-int level)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CurveSpec:
    """A short-Weierstrass curve y^2 = x^3 + a*x + b over GF(modulus)."""

    name: str
    modulus: int  # base field q
    order: int  # scalar field (group order) r
    a: int
    b: int
    gx: int  # generator, affine
    gy: int
    #: group cofactor h = #E(F_q) / r. When h > 1, on-curve points may lie
    #: OUTSIDE the prime-order subgroup the MSM contract assumes (the
    #: reference gets subgroup membership for free from halo2curves' typed
    #: points, src/lib.rs:20-42); validate_inputs checks [r]P == O then.
    cofactor: int = 1

    @property
    def modulus_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def order_bits(self) -> int:
        return self.order.bit_length()


#: BN254 G1 (aka alt_bn128). Matches the modulus baked into the reference at
#: ``src/cuzk/msm.rs:37-43`` and halo2curves' ``bn256::G1``.
BN254 = CurveSpec(
    name="bn254",
    modulus=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    order=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    a=0,
    b=3,
    gx=1,
    gy=2,
)

#: BLS12-377 G1 — the second-curve parameterization (the reference's ZPrize
#: ancestor targeted BLS12-377; its naive path proves two-curve generality
#: with Pallas — ``src/naive/wgsl/pallas/``).
BLS12_377 = CurveSpec(
    name="bls12_377",
    modulus=258664426012969094010652733694893533536393512754914660539884262666720468348340822774968888139573360124440321458177,
    order=8444461749428370424248824938781546531375899335154063827935233455917409239041,
    a=0,
    b=1,
    gx=81937999373150964239938255573465948239988671502647976594219695644855304257327692006745978603320413799295628339695,
    gy=241266749859715473739788878240585681733927191168601896383759122102112907357779751001206799952863815012735208165030,
    cofactor=30631250834960419227450344600217059328,  # (x-1)^2/3, x = 0x8508C00000000001
)

#: Pasta/Pallas curve — kept for parity with the reference's naive path
#: second curve (``src/naive/wgsl/pallas/field.wgsl:4-31``).
PALLAS = CurveSpec(
    name="pallas",
    modulus=28948022309329048855892746252171976963363056481941560715954676764349967630337,
    order=28948022309329048855892746252171976963363056481941647379679742748393362948097,
    a=0,
    b=5,
    gx=28948022309329048855892746252171976963363056481941560715954676764349967630336,  # -1
    gy=2,
)

#: BLS12-381 G1 — the most widely deployed pairing curve (Ethereum, Zcash);
#: 381-bit field (30 limbs @ w=13, same geometry class as BLS12-377). Not in
#: the reference; included to prove the config layer covers the curves a
#: production prover actually serves.
BLS12_381 = CurveSpec(
    name="bls12_381",
    modulus=4002409555221667393417789825735904156556882819939007885332058136124031650490837864442687629129015664037894272559787,
    order=52435875175126190479447740508185965837690552500527637822603658699938581184513,
    a=0,
    b=4,
    gx=3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
    gy=1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569,
    cofactor=76329603384216526031706109802092473003,  # (x-1)^2/3, x = -0xD201000000010000
)

#: secp256k1 — the classic GLV curve (a = 0, p ≡ 1 mod 3, the endomorphism
#: the GLV paper itself targets); 256-bit field with zero slack, so the
#: num_words rule bumps to 21 limbs (R = 2^273 >= 64p). Not in the
#: reference; exercises an even-bit zero-slack modulus end-to-end.
SECP256K1 = CurveSpec(
    name="secp256k1",
    modulus=115792089237316195423570985008687907853269984665640564039457584007908834671663,
    order=115792089237316195423570985008687907852837564279074904382605163141518161494337,
    a=0,
    b=7,
    gx=55066263022277343669578718895168534326250603453777594175500187360389116729240,
    gy=32670510020758816978083085130507043184471273380659243275938904335757337482424,
)

#: Grumpkin — BN254's 2-cycle partner (base/scalar fields swapped; a = 0,
#: b = -17), the inner curve of Aztec/Noir-style recursive provers. A
#: recursion stack that MSMs over BN254 G1 also MSMs over Grumpkin, so the
#: pair belongs together in a serving menu. Same 254-bit/20-limb geometry
#: class as BN254; generator (1, sqrt(-16)) per the Aztec spec.
GRUMPKIN = CurveSpec(
    name="grumpkin",
    modulus=BN254.order,
    order=BN254.modulus,
    a=0,
    b=BN254.order - 17,
    gx=1,
    gy=17631683881184975370165255887551781615748388533673675138860,
)

#: Vesta — Pallas' 2-cycle partner (fields swapped, same a = 0, b = 5,
#: generator (-1, 2) satisfies both curves). With GRUMPKIN this
#: completes both production recursion 2-cycles (BN254/Grumpkin and
#: Pallas/Vesta) in the serving menu.
VESTA = CurveSpec(
    name="vesta",
    modulus=PALLAS.order,
    order=PALLAS.modulus,
    a=0,
    b=5,
    gx=PALLAS.order - 1,
    gy=2,
)

CURVES = {
    c.name: c
    for c in (
        BN254, BLS12_377, PALLAS, BLS12_381, SECP256K1, GRUMPKIN, VESTA,
    )
}


# ---------------------------------------------------------------------------
# Montgomery / Barrett parameter derivation
# ---------------------------------------------------------------------------


def egcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd: returns (g, x, y) with a*x + b*y = g.

    Reference equivalent: ``src/cuzk/utils.rs:293-300``.
    """
    if a == 0:
        return b, 0, 1
    g, x, y = egcd(b % a, a)
    return g, y - (b // a) * x, x


def calc_rinv_and_n0(p: int, r: int, word_size: int) -> tuple[int, int]:
    """Derive the Montgomery inverse of R and the REDC constant n0.

    rinv satisfies ``r * rinv ≡ 1 (mod p)``; n0 = ``-p^-1 mod 2^word_size``
    (the per-limb REDC multiplier). Reference: ``src/cuzk/utils.rs:339-348``.
    """
    g, rinv, pprime = egcd(r % p, p)
    assert g == 1
    rinv %= p
    # n0 = -p^{-1} mod 2^w  (derive from p^{-1} mod 2^w)
    w = 1 << word_size
    pinv = pow(p, -1, w)
    n0 = (-pinv) % w
    assert (p * n0) % w == w - 1  # p * n0 ≡ -1 (mod 2^w)
    return rinv, n0


def gen_mu(p: int, num_bits: int) -> int:
    """Barrett constant mu = floor(4^k / p) with 2^k the first power of two
    at or above p — k == num_bits == p.bit_length() for non-power-of-two p.
    Reference: ``src/cuzk/utils.rs:261-270``.
    """
    x = 1 << num_bits
    while x < p:  # only if the caller passed num_bits < p.bit_length()
        x <<= 1
    assert x // 2 < p <= x
    return (x * x) // p


# ---------------------------------------------------------------------------
# The full MSM configuration
# ---------------------------------------------------------------------------


def calc_num_words(word_size: int, num_bits: int) -> int:
    """ceil(num_bits / word_size) — reference ``src/cuzk/msm.rs:24-31``."""
    return -(-num_bits // word_size)


@dataclass(frozen=True)
class MsmConfig:
    """Static configuration closed over by every kernel factory.

    Analogue of ``ShaderManager``'s template data
    (``src/cuzk/shader_manager.rs:54-100``): limb geometry, window geometry
    and the baked field constants, all derived from (curve, word_size,
    chunk_size).
    """

    curve: CurveSpec
    word_size: int = 13  # limb bit-width (reference WORD_SIZE, msm.rs:34)
    chunk_size: int = 16  # scalar window bit-width (msm.rs:79)
    glv: bool = False  # GLV endomorphism split (ops/glv.py): half the
    #                    windows over 2x points; needs curve.a == 0

    # ---- limb geometry -----------------------------------------------------
    @property
    def num_words(self) -> int:
        """ceil((bits + 6) / word_size): the reference's rule (msm.rs:24-31)
        plus >= 6 bits of slack so R >= 64p — required by the lazy-reduction
        field algebra (ops/field.py). BN254 @ 13 bits still gives 20 words,
        matching the reference; zero-slack moduli (BLS12-377: 377 = 29*13)
        gain one headroom limb."""
        return calc_num_words(self.word_size, self.curve.modulus_bits + 6)

    @property
    def mask(self) -> int:
        return (1 << self.word_size) - 1

    # ---- scalar-window geometry -------------------------------------------
    @property
    def scalar_bits(self) -> int:
        # scalars are serialized as 256-bit LE (reference packs Fr into 32
        # bytes, lib.rs:50-57); windows tile the full 256 bits like
        # num_subtasks = ceil(256/chunk_size) at msm.rs:82.
        return 256 if self.curve.order_bits <= 256 else 8 * (
            (self.curve.order_bits + 7) // 8
        )

    @property
    def num_subtasks(self) -> int:
        # Window-count rule: S = ceil((value_bits + 1) / chunk_size). The
        # +1 is the signed-recode headroom — the top window must come out
        # <= 2^(c-1) after carry absorption (ops/decompose.signed_recode),
        # which holds iff the decomposed value is < 2^(c*S - 1). The
        # reference's ceil(256/chunk) (msm.rs:82) coincides for <= 255-bit
        # orders; a full 256-bit order (secp256k1) genuinely needs the
        # extra window.
        if self.glv:
            # windows cover the GLV half-scalar bound |k_i| <= max_component
            # (< 2^126 for BN254 with the exact Babai rounding): 8 windows
            # at chunk 16 instead of 16
            from msm_tpu.ops.glv import glv_params

            bits = glv_params(self.curve).half_bits
        else:
            bits = self.curve.order_bits
        return -(-(bits + 1) // self.chunk_size)

    @property
    def num_buckets(self) -> int:
        """Signed-bucket count per subtask: |digit| in [0, 2^(c-1)]."""
        return (1 << (self.chunk_size - 1)) + 1

    @property
    def index_shift(self) -> int:
        return 1 << (self.chunk_size - 1)

    # ---- Montgomery / Barrett constants -----------------------------------
    @property
    def r(self) -> int:
        """Montgomery radix R = 2^(word_size*num_words) mod p."""
        return (1 << (self.word_size * self.num_words)) % self.curve.modulus

    @functools.cached_property
    def _rinv_n0(self) -> tuple[int, int]:
        return calc_rinv_and_n0(self.curve.modulus, self.r, self.word_size)

    @property
    def rinv(self) -> int:
        return self._rinv_n0[0]

    @property
    def n0(self) -> int:
        return self._rinv_n0[1]

    @property
    def r2(self) -> int:
        """R^2 mod p — multiply by this (mont_mul) to enter Montgomery form."""
        return (self.r * self.r) % self.curve.modulus

    @functools.cached_property
    def mu(self) -> int:
        return gen_mu(self.curve.modulus, self.curve.modulus_bits)

    @property
    def small_b3(self) -> int | None:
        """3b as a plain small integer when it fits comfortably in the limb
        budget (all shipped curves qualify: BN254 3b=9, BLS12-377 3b=3,
        Pasta 3b=15). Multiplying a Montgomery-form value by a plain small
        integer stays in Montgomery form (k * xR = (kx)R), so the scan
        kernel replaces the two mont_muls-by-mont(3b) per point add with
        one integer multiply + carry sweep each."""
        b3 = 3 * self.curve.b
        return b3 if b3 * ((1 << self.word_size) + 64) < (1 << 31) // 4 else None

    @property
    def slack(self) -> int:
        """Bits of headroom between num_words*word_size and the first power
        of two above p (used by Barrett's high-bits extraction; reference
        ``shader_manager.rs`` bakes this as `slack`)."""
        k = self.curve.modulus_bits
        return self.num_words * self.word_size - k

    def __post_init__(self) -> None:
        if not (8 <= self.word_size <= 16):
            raise ValueError("word_size must be in [8, 16] for int32 lanes")
        if not (1 <= self.chunk_size <= 16):
            raise ValueError("chunk_size must be in [1, 16]")
        if self.glv and self.curve.a != 0:
            raise ValueError("GLV needs an a=0 curve (cube-root endomorphism)")


#: Default config — mirrors the reference's production choice: 13-bit limbs,
#: 20 words, 16-bit windows, 16 subtasks (``src/cuzk/msm.rs:34,79-82``).
DEFAULT_CONFIG = MsmConfig(curve=BN254)


def pick_chunk_size(n: int) -> int:
    """Size-dependent window rule (the reference's ``chunk_size = n>=65536 ?
    16 : 4`` heuristic at msm.rs:79, re-tuned for this implementation):
    small n is bucket-machinery-bound, so smaller windows win. Not yet
    tuned on the H100.
    """
    if n <= (1 << 16):
        return 13
    if n <= (1 << 18):
        return 14
    return 16


@functools.lru_cache(maxsize=None)
def pick_config(n: int, curve: CurveSpec = BN254) -> MsmConfig:
    """n-aware production config (used when the caller passes no explicit
    MsmConfig)."""
    return MsmConfig(curve=curve, chunk_size=pick_chunk_size(max(n, 16)))
