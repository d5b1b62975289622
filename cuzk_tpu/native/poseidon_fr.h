// BN254-Fr arithmetic and the Poseidon permutation/sponge, one state per
// thread, shared by the CUDA kernel (poseidon_cuda.cu, nvcc) and its host
// test shim (poseidon_fr_test.cpp, g++).
//
// Semantics are the reference's, bit for bit (SURVEY.md Appendix A):
// wrap-at-2^256 adds, the truncated k-fold 512->256 reduction with the CPU
// k constant, t=3 Poseidon with R_F=8, R_P=56 and the x^5 S-box.  Elements
// are four little-endian 64-bit limbs.  This is a second, independent
// implementation of what native/oracle.cpp computes: branchless where the
// oracle loops (the subtractive reduce is three conditional subtracts of
// 4p/2p/p), with the MDS products specialised to a one-limb multiplier.
//
// At the kernel boundary elements arrive and leave as the repo's resident
// format, 16 little-endian 16-bit digits in uint32 lanes (cuzk_tpu.field.fr).

#ifndef CUZK_POSEIDON_FR_H_
#define CUZK_POSEIDON_FR_H_

#include <cstdint>

#if defined(__CUDACC__)
#define CUZK_HD __host__ __device__ __forceinline__
#else
#define CUZK_HD inline
#endif

namespace cuzk {

using u32 = std::uint32_t;
using u64 = std::uint64_t;

struct Fe {
  u64 v[4];
};

constexpr int kT = 3;
constexpr int kFullRounds = 8;
constexpr int kPartialRounds = 56;
constexpr int kRounds = kFullRounds + kPartialRounds;
constexpr int kNumRc = kRounds * kT;
constexpr int kDigits = 16;

// p and k = 2^256 mod p (the reference's CPU constant; SURVEY.md B.1).
CUZK_HD Fe modulus() {
  return Fe{{0x43E1F593F0000001ull, 0x2833E84879B97091ull,
             0xB85045B68181585Dull, 0x30644E72E131A029ull}};
}
CUZK_HD Fe kfold() {
  return Fe{{0xAC96341C4FFFFFFBull, 0x36FC76959F60CD29ull,
             0x666EA36F7879462Eull, 0x0E0A77C19A07DF2Full}};
}

CUZK_HD u64 mulhi(u64 a, u64 b) {
#if defined(__CUDA_ARCH__)
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// a + b + carry (carry in {0, 1}); carry becomes the carry out.
CUZK_HD u64 addc(u64 a, u64 b, u64 &carry) {
  u64 s = a + b;
  u64 c = s < a;
  u64 r = s + carry;
  c += r < s;
  carry = c;
  return r;
}

// a - b - borrow (borrow in {0, 1}); borrow becomes the borrow out.
CUZK_HD u64 subb(u64 a, u64 b, u64 &borrow) {
  u64 d = a - b;
  u64 o = a < b;
  u64 r = d - borrow;
  o |= d < borrow;
  borrow = o;
  return r;
}

CUZK_HD bool is_zero(const Fe &a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

// (a + b) mod 2^256: the reference's limb add with the carry dropped.
CUZK_HD Fe wrap_add(const Fe &a, const Fe &b) {
  Fe r;
  u64 c = 0;
  for (int i = 0; i < 4; ++i) r.v[i] = addc(a.v[i], b.v[i], c);
  return r;
}

// a - m if a >= m, else a.
CUZK_HD Fe cond_sub(const Fe &a, const Fe &m) {
  Fe d;
  u64 b = 0;
  for (int i = 0; i < 4; ++i) d.v[i] = subb(a.v[i], m.v[i], b);
  u64 keep = 0 - b;  // all ones when a < m
  Fe r;
  for (int i = 0; i < 4; ++i) r.v[i] = (a.v[i] & keep) | (d.v[i] & ~keep);
  return r;
}

CUZK_HD Fe times_small(const Fe &a, u64 c) {
  // a * c mod 2^256 for the constants 2 and 4 (no carry out needed: the
  // callers only scale p, and 4p < 2^256).
  Fe r;
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u64 lo = a.v[i] * c;
    u64 hi = mulhi(a.v[i], c);
    r.v[i] = lo + carry;
    carry = hi + (r.v[i] < lo);
  }
  return r;
}

// a mod p for any a < 2^256.  The reference loops `while (a >= p) a -= p`
// (at most five times, since 2^256 < 6p); subtracting 4p, 2p and p each
// when they fit leaves the same residue.
CUZK_HD Fe red(const Fe &a) {
  const Fe p = modulus();
  Fe r = cond_sub(a, times_small(p, 4));
  r = cond_sub(r, times_small(p, 2));
  return cond_sub(r, p);
}

// Field add for any canonical operands: wrap at 2^256, then reduce.
CUZK_HD Fe add(const Fe &a, const Fe &b) { return red(wrap_add(a, b)); }

// Field add for reduced operands (a, b < p): a + b < 2p never wraps, so one
// conditional subtract gives exactly what add() gives.
CUZK_HD Fe add_rr(const Fe &a, const Fe &b) {
  return cond_sub(wrap_add(a, b), modulus());
}

// Exact 512-bit schoolbook product, out[0..7].
CUZK_HD void mul_wide(const Fe &a, const Fe &b, u64 out[8]) {
  for (int i = 0; i < 8; ++i) out[i] = 0;
  for (int i = 0; i < 4; ++i) {
    u64 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u64 lo = a.v[i] * b.v[j];
      u64 hi = mulhi(a.v[i], b.v[j]);
      u64 s = out[i + j] + lo;
      hi += s < lo;
      u64 t = s + carry;
      hi += t < carry;
      out[i + j] = t;
      carry = hi;
    }
    out[i + 4] = carry;
  }
}

// Low 256 bits of a * b (the high half is never formed).
CUZK_HD Fe mul_low(const Fe &a, const Fe &b) {
  u64 out[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u64 carry = 0;
    for (int j = 0; i + j < 4; ++j) {
      u64 lo = a.v[i] * b.v[j];
      u64 hi = mulhi(a.v[i], b.v[j]);
      u64 s = out[i + j] + lo;
      hi += s < lo;
      u64 t = s + carry;
      hi += t < carry;
      out[i + j] = t;
      carry = hi;
    }
  }
  return Fe{{out[0], out[1], out[2], out[3]}};
}

// The truncated k-fold reduction of low + high * 2^256.  high == 0 needs no
// branch: it gives hc == 0 and add(low, 0) == red(low).  The mh select does
// matter: with mh == 0 the oracle leaves hc unreduced.
CUZK_HD Fe reduce_wide(const Fe &low, const Fe &high) {
  u64 m[8];
  mul_wide(high, kfold(), m);
  Fe hc = {{m[0], m[1], m[2], m[3]}};
  Fe mh = {{m[4], m[5], m[6], m[7]}};
  if (!is_zero(mh)) hc = add(hc, mul_low(mh, kfold()));
  return add(low, hc);
}

CUZK_HD Fe mul(const Fe &a, const Fe &b) {
  u64 prod[8];
  mul_wide(a, b, prod);
  return reduce_wide(Fe{{prod[0], prod[1], prod[2], prod[3]}},
                     Fe{{prod[4], prod[5], prod[6], prod[7]}});
}

// mul(c, a) for a one-limb c: the product's high half is the single limb
// h, so both k-fold products are one limb by four.
CUZK_HD Fe mul_small(u64 c, const Fe &a) {
  Fe low;
  u64 carry = 0;
  for (int i = 0; i < 4; ++i) {
    u64 lo = a.v[i] * c;
    u64 hi = mulhi(a.v[i], c);
    low.v[i] = lo + carry;
    carry = hi + (low.v[i] < lo);
  }
  const u64 h = carry;
  const Fe k = kfold();
  Fe hc;
  carry = 0;
  for (int i = 0; i < 4; ++i) {
    u64 lo = k.v[i] * h;
    u64 hi = mulhi(k.v[i], h);
    hc.v[i] = lo + carry;
    carry = hi + (hc.v[i] < lo);
  }
  const u64 mh = carry;
  if (mh != 0) {
    Fe mk;
    u64 c2 = 0;
    for (int i = 0; i < 4; ++i) {
      u64 lo = k.v[i] * mh;
      u64 hi = mulhi(k.v[i], mh);
      mk.v[i] = lo + c2;
      c2 = hi + (mk.v[i] < lo);
    }
    hc = add(hc, mk);
  }
  return add(low, hc);
}

CUZK_HD Fe power5(const Fe &a) {
  Fe a2 = mul(a, a);
  Fe a4 = mul(a2, a2);
  return mul(a4, a);
}

// 3x3 MDS matrix, row-major (poseidon.cpp:46-58).
CUZK_HD u64 mds(int i) {
  constexpr u64 kMds[9] = {7, 23, 8, 26, 5, 4, 15, 20, 9};
  return kMds[i];
}

// new_s[i] = sum_j MDS[i][j] * s[j], summed left to right from zero.  The
// products are reduced, so add(0, x) == x and the sums take add_rr.
CUZK_HD void mds_layer(Fe s[kT]) {
  Fe n[kT];
  for (int i = 0; i < kT; ++i) {
    Fe acc = mul_small(mds(kT * i), s[0]);
    for (int j = 1; j < kT; ++j) acc = add_rr(acc, mul_small(mds(kT * i + j), s[j]));
    n[i] = acc;
  }
  for (int i = 0; i < kT; ++i) s[i] = n[i];
}

// The 64-round permutation (poseidon.cpp:60-87).  ``rc`` holds the 192
// reduced round constants.  Round 0 adds with the full wrapping add when
// the state may be any 256-bit value (the raw permutation API); the sponge
// feeds reduced state, where add_rr is exact.  Every later value is a
// reduced product or sum, so rounds 1.. always take add_rr.
template <typename RcAt>
CUZK_HD void permute(Fe s[kT], RcAt rc, bool full_round0_add) {
  for (int i = 0; i < kT; ++i)
    s[i] = full_round0_add ? add(s[i], rc(i)) : add_rr(s[i], rc(i));
  for (int r = 0; r < kRounds; ++r) {
    if (r > 0)
      for (int i = 0; i < kT; ++i) s[i] = add_rr(s[i], rc(kT * r + i));
    const bool full = r < kFullRounds / 2 || r >= kFullRounds / 2 + kPartialRounds;
    if (full) {
      for (int i = 0; i < kT; ++i) s[i] = power5(s[i]);
    } else {
      s[0] = power5(s[0]);
    }
    mds_layer(s);
  }
}

// 16 digits (each < 2^32) -> their value mod 2^256.  Digits need not be
// canonical: the value is sum(d_i * 2^(16 i)) with the carry out of the top
// dropped, which is what the jnp path's first wrapping add computes.
CUZK_HD Fe from_digits(const u32 *d) {
  Fe r = {{0, 0, 0, 0}};
  u64 acc = 0;
  for (int i = 0; i < kDigits; ++i) {
    acc += d[i];
    r.v[i / 4] |= (acc & 0xFFFFull) << (16 * (i % 4));
    acc >>= 16;
  }
  return r;
}

CUZK_HD void to_digits(const Fe &a, u32 *d) {
  for (int i = 0; i < kDigits; ++i)
    d[i] = (u32)((a.v[i / 4] >> (16 * (i % 4))) & 0xFFFFull);
}

// Sponge (poseidon.cpp:103-126): ds in state[0], absorb pairs into
// state[1..2] with the wrapping add (inputs may be any 256-bit value), one
// permutation per absorbed pair, squeeze state[1].  n == 0 returns 0
// without permuting (SURVEY.md B.4).
template <typename InputAt, typename RcAt>
CUZK_HD Fe sponge(InputAt input, int n, u64 ds, RcAt rc) {
  Fe s[kT] = {{{ds, 0, 0, 0}}, {{0, 0, 0, 0}}, {{0, 0, 0, 0}}};
  for (int i = 0; i < n; i += 2) {
    s[1] = add(s[1], input(i));
    if (i + 1 < n) s[2] = add(s[2], input(i + 1));
    permute(s, rc, false);
  }
  return s[1];
}

}  // namespace cuzk

#endif  // CUZK_POSEIDON_FR_H_
