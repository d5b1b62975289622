// Host build of poseidon_fr.h (g++), so the CPU tests can check the
// kernel's field and permutation code against the oracle without a GPU.
// Every element crosses this C ABI as 16 uint32 digits, the kernel's own
// boundary format, so the digit conversions are exercised too.

#include "poseidon_fr.h"

namespace {

using cuzk::Fe;

Fe g_rc[cuzk::kNumRc];
bool g_rc_ready = false;

// RC[i] = add(mul(i + 1, 0x123456789ABCDEF), i * 0x987654321)
// (poseidon.cpp:33-44), computed with this header's own mul and add.
const Fe *rc_table() {
  if (!g_rc_ready) {
    for (int i = 0; i < cuzk::kNumRc; ++i) {
      Fe m = cuzk::mul(Fe{{(cuzk::u64)i + 1, 0, 0, 0}},
                       Fe{{0x123456789ABCDEFull, 0, 0, 0}});
      g_rc[i] = cuzk::add(m, Fe{{(cuzk::u64)i * 0x987654321ull, 0, 0, 0}});
    }
    g_rc_ready = true;
  }
  return g_rc;
}

struct RcHost {
  const Fe *t;
  Fe operator()(int i) const { return t[i]; }
};

}  // namespace

extern "C" {

using cuzk::u32;

void fr_add(const u32 *a, const u32 *b, u32 *out) {
  cuzk::to_digits(cuzk::add(cuzk::from_digits(a), cuzk::from_digits(b)), out);
}

void fr_mul(const u32 *a, const u32 *b, u32 *out) {
  cuzk::to_digits(cuzk::mul(cuzk::from_digits(a), cuzk::from_digits(b)), out);
}

void fr_mul_small(unsigned long long c, const u32 *a, u32 *out) {
  cuzk::to_digits(cuzk::mul_small(c, cuzk::from_digits(a)), out);
}

void fr_red(const u32 *a, u32 *out) {
  cuzk::to_digits(cuzk::red(cuzk::from_digits(a)), out);
}

void fr_power5(const u32 *a, u32 *out) {
  cuzk::to_digits(cuzk::power5(cuzk::from_digits(a)), out);
}

void fr_round_constant(int i, u32 *out) { cuzk::to_digits(rc_table()[i], out); }

// Raw permutation of one [3][16]-digit state, in place.
void fr_permutation(u32 *state) {
  Fe s[cuzk::kT];
  for (int i = 0; i < cuzk::kT; ++i) s[i] = cuzk::from_digits(state + 16 * i);
  cuzk::permute(s, RcHost{rc_table()}, true);
  for (int i = 0; i < cuzk::kT; ++i) cuzk::to_digits(s[i], state + 16 * i);
}

// Sponge over n [16]-digit inputs with domain separator ds.
void fr_sponge(const u32 *inputs, int n, unsigned long long ds, u32 *out) {
  auto input = [&](int i) { return cuzk::from_digits(inputs + 16 * i); };
  cuzk::to_digits(cuzk::sponge(input, n, ds, RcHost{rc_table()}), out);
}

}  // extern "C"
