"""Vectorized BN254-Fr arithmetic: ``[..., 16] uint32`` digit arrays.

A re-limbing of the reference's 4x64-bit ``FieldElement``
(field_arithmetic.hpp:11-44) for plain jnp: a field element is 16
little-endian 16-bit digits held in uint32 lanes, so every digit product
fits a native u32 multiply with no 64-bit emulation.  This digit format is
also the boundary format of the CUDA kernel in ``cuzk_tpu.ops``, which
converts to four 64-bit limbs inside.

Every function here is a pure, batch-vectorized jnp program that reproduces
``cuzk_tpu.oracle`` bit-for-bit, including the deliberate reference quirks
(wrap-at-2^256 adds, truncated k-fold reduction — SURVEY.md Appendix A).
Data-dependent branches of the C++ code (``if (high == 0)``, ``while (a >= p)``)
are made branchless with selects, and carry/borrow propagation is done with
Kogge-Stone generate/propagate scans along the digit axis (log-depth vector
ops instead of a 16/32-step ripple chain): graphs are ~10x smaller than the
naive per-digit formulation, which matters for XLA compile time.
Schoolbook partial-product columns are accumulated with dots against
constant 0/1 spreading matrices (see :func:`_schoolbook_cols`).

This module is the *reference path*; the kernel in ``cuzk_tpu.ops`` is the
accelerated path and are tested differentially against it (the same
oracle/accelerator invariant the reference maintains between its CPU and CUDA
implementations, SURVEY.md §1).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cuzk_tpu import oracle

NDIGITS = 16  # 16 x 16-bit = 256 bits
DIGIT_BITS = 16
DIGIT_MASK = 0xFFFF
NDIGITS_WIDE = 2 * NDIGITS  # 512-bit products


def int_to_digits(x: int, ndigits: int = NDIGITS) -> np.ndarray:
    """Python int -> little-endian 16-bit digit vector (uint32)."""
    if x < 0 or x >= 1 << (DIGIT_BITS * ndigits):
        raise ValueError(f"value out of range for {ndigits} digits")
    return np.array(
        [(x >> (DIGIT_BITS * i)) & DIGIT_MASK for i in range(ndigits)],
        dtype=np.uint32,
    )


def digits_to_int(d) -> int:
    """Digit vector (any length) -> Python int."""
    d = np.asarray(d)
    if d.ndim != 1:
        raise ValueError("digits_to_int takes a single element; use batch helpers")
    return sum(int(v) << (DIGIT_BITS * i) for i, v in enumerate(d.tolist()))


def ints_to_array(xs, ndigits: int = NDIGITS) -> np.ndarray:
    """Sequence of ints -> [n, ndigits] uint32 batch."""
    return np.stack([int_to_digits(int(x), ndigits) for x in xs])


def array_to_ints(a) -> list:
    """[..., ndigits] -> nested list of Python ints (flattened batch)."""
    a = np.asarray(a)
    flat = a.reshape(-1, a.shape[-1])
    return [digits_to_int(row) for row in flat]


def pack16(a: np.ndarray) -> np.ndarray:
    """Host pack: ``[.., 16] uint32`` canonical 16-bit digits ->
    ``[.., 8] uint32`` (two digits per word, little-digit in the low
    half) — 32 B/element, the information-optimal wire format for
    256-bit values over the host->device link.  Callers MUST range-check
    digits < 2^16 first: packing drops high bits, so a non-canonical
    digit >= 2^16 would silently alias a canonical one (soundness
    gates in merkle.py route such inputs to the unpacked path)."""
    a = np.ascontiguousarray(a, np.uint32)
    return a[..., 0::2] | (a[..., 1::2] << np.uint32(16))


def unpack16(p: jnp.ndarray) -> jnp.ndarray:
    """Device inverse of :func:`pack16`: ``[.., 8] -> [.., 16]`` (traced
    into the consuming program, so packed wire data unpacks on-device)."""
    lo = p & jnp.uint32(0xFFFF)
    hi = p >> jnp.uint32(16)
    return jnp.stack([lo, hi], axis=-1).reshape(p.shape[:-1] + (NDIGITS,))


# Constants as numpy digit vectors (folded into compiled executables).
P_DIGITS = int_to_digits(oracle.P)
P2_DIGITS = int_to_digits(2 * oracle.P)
P4_DIGITS = int_to_digits(4 * oracle.P)
K_DIGITS = int_to_digits(oracle.K)
ZERO_DIGITS = int_to_digits(0)
ONE_DIGITS = int_to_digits(1)
TWO_DIGITS = int_to_digits(2)


def _shift_up(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """Shift digits toward higher significance by k places, zero-filled,
    same length (drops the top k digits — the 2^(16n) wrap)."""
    nd = x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 1) + [(k, 0)]
    return jnp.pad(x, pad)[..., :nd]


def _ks_carry(g: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Kogge-Stone inclusive scan of the carry operator.

    g[i]: digit i generates a carry/borrow out; p[i]: digit i propagates an
    incoming one.  Returns G*[i] = carry OUT of digit i assuming zero carry
    into digit 0 (log2(n) steps of whole-array vector ops).
    """
    nd = g.shape[-1]
    shift = 1
    while shift < nd:
        g = g | (p & _shift_up(g, shift))
        p = p & _shift_up(p, shift)
        shift *= 2
    return g


def _carry(cols: jnp.ndarray) -> jnp.ndarray:
    """Canonicalize u32 columns (any values < 2^32) into 16-bit digits,
    dropping the carry out of the top digit — the 2^256 / 2^512 wrap of the
    reference (field_arithmetic.cpp:172-182)."""
    return _carry_keep(cols)[0]


def _carry_keep(cols: jnp.ndarray):
    """Like :func:`_carry` but also returns the dropped carry-out digit.

    Two ripple passes squeeze every digit to <= 2^16, then one Kogge-Stone
    scan resolves the remaining +/-1 carry cascade exactly.
    """
    x = (cols & DIGIT_MASK) + _shift_up(cols >> DIGIT_BITS, 1)
    ca = cols[..., -1] >> DIGIT_BITS
    cb = x[..., -1] >> DIGIT_BITS
    x = (x & DIGIT_MASK) + _shift_up(x >> DIGIT_BITS, 1)
    # now every digit <= 2^16
    g = (x >> DIGIT_BITS).astype(jnp.uint32)
    p = ((x & DIGIT_MASK) == DIGIT_MASK).astype(jnp.uint32)
    gstar = _ks_carry(g, p)
    out = (x + _shift_up(gstar, 1)) & DIGIT_MASK
    return out, ca + cb + gstar[..., -1]


def _sub_digits(a: jnp.ndarray, b: jnp.ndarray):
    """Digit-wise (a - b) mod 2^(16n) with borrow resolution.

    Returns (difference, borrow) where borrow == 1 iff a < b.  Matches the
    reference's borrow-subtract with dropped final borrow
    (field_arithmetic.cpp:203-219).
    """
    a, b = jnp.broadcast_arrays(a, b)
    g = (a < b).astype(jnp.uint32)  # digit generates a borrow
    p = (a == b).astype(jnp.uint32)  # digit propagates an incoming borrow
    borrow_out = _ks_carry(g, p)
    borrow_in = _shift_up(borrow_out, 1)
    base = jnp.uint32(1 << DIGIT_BITS)
    out = (a + base - b - borrow_in) & DIGIT_MASK
    return out, borrow_out[..., -1]


def geq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a >= b as a boolean over the batch."""
    _, borrow = _sub_digits(a, b)
    return borrow == 0


def _cond_sub(a: jnp.ndarray, m) -> jnp.ndarray:
    """a - m if a >= m else a (one step of the subtractive reduce)."""
    diff, borrow = _sub_digits(a, jnp.asarray(m))
    return jnp.where((borrow == 0)[..., None], diff, a)


def red(a: jnp.ndarray) -> jnp.ndarray:
    """a mod p for any canonical a < 2^256.

    The reference loops ``while (a >= p) a -= p`` (up to 5 iterations,
    field_arithmetic.cpp:244-248); subtracting 4p/2p/p conditionally yields
    the identical residue in 3 fixed steps (2^256 - 1 < 6p).  The 3 steps
    run as a ``lax.scan`` over the stacked constants so the conditional
    subtract is traced (and LLVM-compiled) once, not three times — XLA:CPU
    compile cost is per-op, and sponge-sized programs were minutes-slow.
    """
    consts = jnp.stack(
        [jnp.asarray(P4_DIGITS), jnp.asarray(P2_DIGITS), jnp.asarray(P_DIGITS)]
    )

    def step(acc, m):
        return _cond_sub(acc, m), None

    out, _ = jax.lax.scan(step, a, consts)
    return out


def wrap_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """(a + b) mod 2^256 — the reference's carry-dropping limb add."""
    a, b = jnp.broadcast_arrays(a, b)
    return _carry(a + b)


def add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Field add with 2^256 wrap, valid for ANY canonical inputs < 2^256
    (field_arithmetic.cpp:172-182)."""
    return red(wrap_add(a, b))


def add_rr(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Field add for REDUCED operands (a, b < p): a+b < 2p < 2^256 never
    wraps and needs a single conditional subtract.  Bit-identical to
    :func:`add` in this regime; used on the permutation hot path."""
    a, b = jnp.broadcast_arrays(a, b)
    return _cond_sub(_carry(a + b), P_DIGITS)


def sub(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Field subtract with modulus pre-add when a < b
    (field_arithmetic.cpp:184-219).  Both the 2^256 carry of the pre-add and
    the final borrow are dropped, matching the limb code exactly."""
    a, b = jnp.broadcast_arrays(a, b)
    _, borrow = _sub_digits(a, b)
    a_plus_p = _carry(a + jnp.asarray(P_DIGITS))
    t = jnp.where((borrow == 1)[..., None], a_plus_p, a)
    diff, _ = _sub_digits(t, b)
    return diff


import functools


@functools.lru_cache(maxsize=None)
def _spread_matrices(n_out: int):
    """Constant 0/1 matrices scattering flattened partial products into
    columns: product (i, j) -> flat index 16*i + j; its low half lands in
    column i+j, its high half in column i+j+1 (columns >= n_out dropped —
    the & M truncation of mul_low)."""
    sl = np.zeros((NDIGITS * NDIGITS, n_out), np.uint32)
    sh = np.zeros((NDIGITS * NDIGITS, n_out), np.uint32)
    for i in range(NDIGITS):
        for j in range(NDIGITS):
            if i + j < n_out:
                sl[NDIGITS * i + j, i + j] = 1
            if i + j + 1 < n_out:
                sh[NDIGITS * i + j, i + j + 1] = 1
    return sl, sh


def _schoolbook_cols(a: jnp.ndarray, b: jnp.ndarray, n_out: int):
    """Partial-product column sums: lo[i,j] lands in column i+j, hi[i,j] in
    column i+j+1, accumulated as TWO dots against constant 0/1 spreading
    matrices.  The dot form is ~5 HLO ops where a padded-row-add form is
    ~130 — the single largest term of sponge compile time.

    The dots run in float32 at ``Precision.HIGHEST`` on every backend.
    That is exact: every operand is < 2^16 and every column sum (at most 32
    terms) is < 2^21 < 2^24, so each partial sum is an integer float32
    holds exactly.  HIGHEST is load-bearing on the GPU, where a default-
    precision float32 dot runs in TF32 (10 mantissa bits) and silently
    breaks bit-exactness; on the CPU it compiles to the same Eigen GEMM as
    the default.  (A uint32 dot is exact too, but cuBLAS has no integer
    GEMM; PERF.md records what XLA:GPU made of it.)
    """
    prod = a[..., :, None] * b[..., None, :]  # [..., 16, 16], exact in u32
    flat_shape = prod.shape[:-2] + (NDIGITS * NDIGITS,)
    lo = (prod & DIGIT_MASK).reshape(flat_shape).astype(jnp.float32)
    hi = (prod >> DIGIT_BITS).reshape(flat_shape).astype(jnp.float32)
    sl, sh = _spread_matrices(n_out)
    dims = (((lo.ndim - 1,), (0,)), ((), ()))
    hp = jax.lax.Precision.HIGHEST
    cols = jax.lax.dot_general(
        lo, jnp.asarray(sl, jnp.float32), dims, precision=hp
    ) + jax.lax.dot_general(hi, jnp.asarray(sh, jnp.float32), dims, precision=hp)
    return cols.astype(jnp.uint32)


def mul_wide(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Exact 512-bit schoolbook product as 32 canonical digits
    (field_arithmetic.cpp:221-238)."""
    a, b = jnp.broadcast_arrays(a, b)
    return _carry(_schoolbook_cols(a, b, NDIGITS_WIDE))


def mul_low(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Low 256 bits of the exact product: ``(a*b) & (2^256-1)``.

    Only digit products with i+j <= 15 influence the low half; the carry out
    of digit 15 is discarded (the truncation in field_arithmetic.cpp:318-322).
    """
    a, b = jnp.broadcast_arrays(a, b)
    return _carry(_schoolbook_cols(a, b, NDIGITS))


def reduce_wide(prod: jnp.ndarray) -> jnp.ndarray:
    """The truncated k-fold 512->256 reduction, branchless
    (field_arithmetic.cpp:250-330; semantics pinned in SURVEY.md Appendix A).

    All three oracle branches (high == 0, mh == 0, mh != 0) are computed and
    selected per element, so the compiled program is data-independent.
    """
    low = prod[..., :NDIGITS]
    high = prod[..., NDIGITS:]

    m = mul_wide(high, jnp.asarray(K_DIGITS))
    hc = m[..., :NDIGITS]
    mh = m[..., NDIGITS:]
    mh_zero = jnp.all(mh == 0, axis=-1)

    mhk_low = mul_low(mh, jnp.asarray(K_DIGITS))  # (mh*k) & M — high part dropped
    hc = jnp.where(mh_zero[..., None], hc, add(hc, mhk_low))
    # The oracle's high == 0 early-out needs no select: high == 0 gives
    # hc == 0 and add(low, 0) == red(low), bit-identical.  (The mh select IS
    # load-bearing: hc stays unreduced there.)
    return add(low, hc)


def mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Field multiply: exact 512-bit product + truncated reduction."""
    return reduce_wide(mul_wide(a, b))


def square(a: jnp.ndarray) -> jnp.ndarray:
    return mul(a, a)


def power5(a: jnp.ndarray) -> jnp.ndarray:
    """a^5 = ((a^2)^2)*a (field_arithmetic.cpp:332-338).

    The three dependent multiplies run as a 3-step ``lax.scan`` whose body is
    ONE traced :func:`mul` (step 2 swaps the right operand from the running
    square to the original ``a`` via a select), so the multiply's program is
    LLVM-compiled once instead of three times.  Bit-identical to the inline
    chain; cuts the compile cost of every power5 (and with it the 64-round
    sponge, which is dominated by S-box multiplies) roughly in half.
    """

    def step(cur, i):
        rhs = jnp.where(i == 2, a, cur)
        return mul(cur, rhs), None

    out, _ = jax.lax.scan(step, a, jnp.arange(3))
    return out


def mul_small(a: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Field multiply by a small constant c < 2^16 — bit-identical to
    ``mul(a, c)`` but ~6x cheaper.

    Because c fits one digit, the 512-bit product is 17 digits (high < 2^16),
    and both k-fold multiplies inside the reduction are also
    one-digit-by-field products.  Used for the tiny MDS coefficients
    {4..26} on the permutation hot path (SURVEY.md §7 hard part #2).
    """
    c = jnp.asarray(c, jnp.uint32)
    low, high = _carry_keep(a * c[..., None])  # prod = low + high*2^256

    k = jnp.asarray(K_DIGITS)
    m_low, mh = _carry_keep(k * high[..., None])  # m = high*k, 17 digits
    mh_zero = mh == 0

    mhk_low, _ = _carry_keep(k * mh[..., None])  # (mh*k) & M
    hc = jnp.where(mh_zero[..., None], m_low, add(m_low, mhk_low))
    # high == 0 => hc == 0 => add(low, 0) == red(low): no select needed.
    return add(low, hc)


def is_zero(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == 0, axis=-1)


def eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    a, b = jnp.broadcast_arrays(a, b)
    return jnp.all(a == b, axis=-1)


# Jit the public entry points: compiled once per shape, they fuse into tight
# code; eager per-op dispatch of digit-level programs would be slow.
add = jax.jit(add)
add_rr = jax.jit(add_rr)
sub = jax.jit(sub)
red = jax.jit(red)
wrap_add = jax.jit(wrap_add)
mul_wide = jax.jit(mul_wide)
mul_low = jax.jit(mul_low)
mul = jax.jit(mul)
square = jax.jit(square)
power5 = jax.jit(power5)
mul_small = jax.jit(mul_small)
geq = jax.jit(geq)
eq = jax.jit(eq)
is_zero = jax.jit(is_zero)
