// Fast CPU MSM oracle for BN254 and BLS12-381 G1 — the in-repo replacement for the
// reference's external `halo2curves` crate oracle (reference usage:
// src/lib.rs:45-47 `cpu_msm` -> halo2curves msm_best; naive path
// `best_multiexp` at src/naive/halo2curves/mod.rs:31-33).
//
// Design: NLx64-bit-limb Montgomery field arithmetic (CIOS with unsigned
// __int128 carries; NL = 4 for BN254, 6 for BLS12-381), Jacobian G1 group ops (dbl-2009-l / add-2007-bl — the
// same formula family the reference's WGSL EC library uses,
// src/cuzk/wgsl/curve/ec.template.wgsl:10-86), and a windowed Pippenger MSM
// (the role halo2curves' msm_best plays). Exposed to Python over a minimal
// C ABI (see msm_tpu/oracle/native.py).
//
// Wire format (all little-endian byte strings, standard — non-Montgomery —
// form, matching the reference's field serialization, lib.rs:50-65), with
// FB = 8 * NL bytes per field element (32 for BN254, 48 for BLS12-381):
//   points : n * 2*FB bytes  (x || y), x=y=0 encodes the identity
//   scalars: n * 32 bytes
//   out    : 3*FB bytes Jacobian (x || y || z), z=0 encodes the identity

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace bn254 {
#define NL 4
#define P_INIT {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL, 0xb85045b68181585dULL, 0x30644e72e131a029ULL}
#define N0_INIT 0x87d20782e4866389ULL
#define R1_INIT {0xd35d438dc58f0d9dULL, 0x0a78eb28f5c70b3dULL, 0x666ea36f7879462cULL, 0x0e0a77c19a07df2fULL}
#define R2_INIT {0xf32cfc5b538afa89ULL, 0xb5e71911d44501fbULL, 0x47ab1eff0a417ff6ULL, 0x06d89f71cab8351fULL}
#include "msm_curve.inc"
#undef NL
#undef P_INIT
#undef N0_INIT
#undef R1_INIT
#undef R2_INIT
}  // namespace bn254

namespace bls12_381 {
#define NL 6
#define P_INIT {0xb9feffffffffaaabULL, 0x1eabfffeb153ffffULL, 0x6730d2a0f6b0f624ULL, 0x64774b84f38512bfULL, 0x4b1ba7b6434bacd7ULL, 0x1a0111ea397fe69aULL}
#define N0_INIT 0x89f3fffcfffcfffdULL
#define R1_INIT {0x760900000002fffdULL, 0xebf4000bc40c0002ULL, 0x5f48985753c758baULL, 0x77ce585370525745ULL, 0x5c071a97a256ec6dULL, 0x15f65ec3fa80e493ULL}
#define R2_INIT {0xf4df1f341c341746ULL, 0x0a76e6a609d104f1ULL, 0x8de5476c4c95b6d5ULL, 0x67eb88a9939d83c0ULL, 0x9a793e85b519952dULL, 0x11988fe592cae3aaULL}
#include "msm_curve.inc"
#undef NL
#undef P_INIT
#undef N0_INIT
#undef R1_INIT
#undef R2_INIT
}  // namespace bls12_381

}  // namespace

extern "C" {

int msm_bn254(const std::uint8_t *points, const std::uint8_t *scalars,
              std::size_t n, std::uint8_t *out) {
  return bn254::msm_entry(points, scalars, n, out);
}

int msm_bls12_381(const std::uint8_t *points, const std::uint8_t *scalars,
                  std::size_t n, std::uint8_t *out) {
  return bls12_381::msm_entry(points, scalars, n, out);
}

// single point ops for differential testing of the C++ itself
int g1_add_bn254(const std::uint8_t *p96, const std::uint8_t *q96,
                 std::uint8_t *out96) {
  return bn254::add_entry(p96, q96, out96);
}

int g1_double_bn254(const std::uint8_t *p96, std::uint8_t *out96) {
  return bn254::double_entry(p96, out96);
}

int g1_add_bls12_381(const std::uint8_t *p144, const std::uint8_t *q144,
                     std::uint8_t *out144) {
  return bls12_381::add_entry(p144, q144, out144);
}

int g1_double_bls12_381(const std::uint8_t *p144, std::uint8_t *out144) {
  return bls12_381::double_entry(p144, out144);
}

}  // extern "C"
