"""Differential tests: jnp field layer vs the exact Python-int oracle.

Mirrors the reference's CPU-as-oracle differential strategy
(test_field_arithmetic_cuda.cpp) but with adversarial regime coverage the
reference lacks (SURVEY.md §4): high == 0 / small high / large high /
wrap-add cases all exercised.
"""

import random

import numpy as np
import pytest

from cuzk_tpu import oracle
from cuzk_tpu.field import fr

rng = random.Random(1234)


def rand_reduced(n):
    return [rng.randrange(oracle.P) for _ in range(n)]


def rand_full(n):
    """Arbitrary canonical 256-bit values (may exceed p)."""
    return [rng.randrange(1 << 256) for _ in range(n)]


def check_unary(jnp_fn, oracle_fn, xs):
    got = fr.array_to_ints(jnp_fn(fr.ints_to_array(xs)))
    want = [oracle_fn(x) for x in xs]
    assert got == want


def check_binary(jnp_fn, oracle_fn, pairs):
    a = fr.ints_to_array([p[0] for p in pairs])
    b = fr.ints_to_array([p[1] for p in pairs])
    got = fr.array_to_ints(jnp_fn(a, b))
    want = [oracle_fn(x, y) for x, y in pairs]
    assert got == want


def test_digit_roundtrip():
    for x in [0, 1, oracle.P - 1, oracle.P, (1 << 256) - 1] + rand_full(20):
        assert fr.digits_to_int(fr.int_to_digits(x)) == x


def test_add_reduced_and_wrapping():
    pairs = list(zip(rand_reduced(64), rand_reduced(64)))
    # wrap-at-2^256 regime (load-bearing inside reduce_512):
    pairs += list(zip(rand_full(64), rand_full(64)))
    pairs += [(0, 0), ((1 << 256) - 1, (1 << 256) - 1), (oracle.P, oracle.P)]
    check_binary(fr.add, oracle.add, pairs)


def test_add_rr_matches_add_for_reduced():
    pairs = list(zip(rand_reduced(64), rand_reduced(64)))
    check_binary(fr.add_rr, oracle.add, pairs)


def test_sub():
    pairs = list(zip(rand_reduced(64), rand_reduced(64)))
    pairs += [(0, 0), (0, 1), (1, 0), (0, oracle.P - 1), (5, 5)]
    check_binary(fr.sub, oracle.sub, pairs)
    # (a-b)+b == a round-trip
    a = fr.ints_to_array(rand_reduced(32))
    b = fr.ints_to_array(rand_reduced(32))
    assert fr.array_to_ints(fr.add(fr.sub(a, b), b)) == fr.array_to_ints(a)


def test_mul_wide_exact():
    pairs = list(zip(rand_full(32), rand_full(32)))
    a = fr.ints_to_array([p[0] for p in pairs])
    b = fr.ints_to_array([p[1] for p in pairs])
    got = fr.array_to_ints(fr.mul_wide(a, b))
    want = [x * y for x, y in pairs]
    assert got == want


def test_mul_low_exact():
    pairs = list(zip(rand_full(32), rand_full(32)))
    a = fr.ints_to_array([p[0] for p in pairs])
    b = fr.ints_to_array([p[1] for p in pairs])
    got = fr.array_to_ints(fr.mul_low(a, b))
    want = [(x * y) & ((1 << 256) - 1) for x, y in pairs]
    assert got == want


def test_mul_all_regimes():
    pairs = []
    # high == 0 regime (product < 2^256)
    pairs += [(rng.randrange(1 << 128), rng.randrange(1 << 128)) for _ in range(16)]
    # small-high regime (the only one the reference's tests cover)
    pairs += [(rng.randrange(1, 11), rng.randrange(oracle.P)) for _ in range(16)]
    # full random reduced pairs — the regime where truncation deviates
    pairs += list(zip(rand_reduced(48), rand_reduced(48)))
    # full canonical (unreduced) inputs
    pairs += list(zip(rand_full(32), rand_full(32)))
    # adversarial extremes
    top = (1 << 256) - 1
    pairs += [(top, top), (oracle.P - 1, oracle.P - 1), (0, top), (1, top)]
    check_binary(fr.mul, oracle.mul, pairs)


def test_mul_truncation_golden():
    a = int("0x123456789abcdef0fedcba987654321011112222333344445555666677778888", 16)
    b = int("0x0fedcba987654321123456789abcdef0aaaabbbbccccddddeeeeffff00001111", 16)
    got = fr.array_to_ints(fr.mul(fr.ints_to_array([a]), fr.ints_to_array([b])))[0]
    assert got == int(
        "0x19f690df510f402ffef3bf6bfc5f36bf54cac399b184b355725667a3eefc6378", 16
    )


def test_square_power5():
    xs = rand_reduced(32) + [0, 1, 2, oracle.P - 1]
    check_unary(fr.square, oracle.square, xs)
    check_unary(fr.power5, oracle.power5, xs)


def test_mul_small_matches_oracle_mul():
    consts = list(oracle.MDS) + [0, 1, 2, 3, 255, 65535]
    xs = rand_reduced(16) + rand_full(8) + [0, 1, oracle.P - 1, (1 << 256) - 1]
    a = fr.ints_to_array(xs)
    for c in consts:
        got = fr.array_to_ints(fr.mul_small(a, np.uint32(c)))
        want = [oracle.mul(x, c) for x in xs]
        assert got == want, f"mul_small mismatch for c={c}"


def test_red():
    xs = rand_full(64) + [0, oracle.P - 1, oracle.P, 2 * oracle.P, (1 << 256) - 1]
    check_unary(fr.red, oracle.red, xs)


def test_broadcasting_and_shapes():
    a = fr.ints_to_array(rand_reduced(6)).reshape(2, 3, fr.NDIGITS)
    b = fr.ints_to_array(rand_reduced(3)).reshape(3, fr.NDIGITS)
    out = fr.add(a, b)
    assert out.shape == (2, 3, fr.NDIGITS)
    flat_a = fr.array_to_ints(a)
    flat_b = fr.array_to_ints(b) * 2
    assert fr.array_to_ints(out) == [
        oracle.add(x, y) for x, y in zip(flat_a, flat_b)
    ]


def test_jit_compatible():
    import jax

    a = fr.ints_to_array(rand_reduced(8))
    b = fr.ints_to_array(rand_reduced(8))
    jit_mul = jax.jit(fr.mul)
    assert fr.array_to_ints(jit_mul(a, b)) == fr.array_to_ints(fr.mul(a, b))


def test_schoolbook_dots_are_exact_float32_highest():
    """Every dot in the field multiply is float32 at Precision.HIGHEST: a
    default-precision float32 dot runs in TF32 on the GPU (10 mantissa
    bits; the column sums need 21) and silently breaks bit-exactness."""
    import jax
    import jax.numpy as jnp

    a = jnp.zeros((4, fr.NDIGITS), jnp.uint32)
    jaxpr = jax.make_jaxpr(fr.mul.__wrapped__)(a, a)

    def dots(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for sub in jax.core.jaxprs_in_params(eqn.params):
                yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    assert found, "expected the spreading dots in fr.mul"
    for eqn in found:
        assert all(v.aval.dtype == jnp.float32 for v in eqn.invars)
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec
        ), prec


# ---------------------------------------------------------------------------
# Algebraic property tests, mirroring the reference's property-test style
# (test_field_arithmetic.cpp:300-369).  Like the reference, the mul
# properties stay in the small-value regime where the truncated reduction is
# exact (SURVEY.md §4); add properties hold for all reduced values.
# ---------------------------------------------------------------------------

def test_add_properties():
    a, b, c = (fr.ints_to_array([v]) for v in rand_reduced(3))
    zero = fr.ints_to_array([0])
    assert fr.array_to_ints(fr.add(a, zero)) == fr.array_to_ints(a)
    assert fr.array_to_ints(fr.add(a, b)) == fr.array_to_ints(fr.add(b, a))
    assert fr.array_to_ints(fr.add(fr.add(a, b), c)) == fr.array_to_ints(
        fr.add(a, fr.add(b, c))
    )


def test_sub_add_roundtrip():
    xs, ys = rand_reduced(8), rand_reduced(8)
    a, b = fr.ints_to_array(xs), fr.ints_to_array(ys)
    got = fr.array_to_ints(fr.add(fr.sub(a, b), b))
    assert got == [x % oracle.P for x in xs]


def test_mul_properties_small_regime():
    small = [rng.randrange(1 << 120) for _ in range(4)]
    a, b = fr.ints_to_array(small[:2]), fr.ints_to_array(small[2:])
    one = fr.ints_to_array([1, 1])
    assert fr.array_to_ints(fr.mul(a, one)) == [x % oracle.P for x in small[:2]]
    assert fr.array_to_ints(fr.mul(a, b)) == fr.array_to_ints(fr.mul(b, a))


def test_determinism():
    xs = rand_full(4)
    a = fr.ints_to_array(xs)
    r1 = fr.array_to_ints(fr.mul(a, a))
    r2 = fr.array_to_ints(fr.mul(a, a))
    assert r1 == r2
