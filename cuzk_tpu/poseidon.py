"""Batched Poseidon hash (t=3, R_F=8, R_P=56, x^5 S-box) over BN254 Fr.

A plain-jnp re-design of the reference's scalar CPU implementation
(poseidon.{hpp,cpp}) and its CUDA batch kernels (cuda/poseidon_cuda.cu,
cuda/poseidon_cuda_optimized.cu): instead of one thread per state, every
function here is a pure jnp program over
``[..., 16] uint32`` digit arrays, batch-vectorized across leading axes, with
the 64 rounds expressed as three ``lax.scan`` phases (4 full / 56 partial /
4 full — poseidon.cpp:60-87) so the whole permutation compiles to one fused
XLA program.  Bit-exact against ``cuzk_tpu.oracle`` (SURVEY.md Appendix A).

Design notes vs the reference:
- Round constants (poseidon.cpp:33-44) and the 3x3 MDS matrix
  (poseidon.cpp:46-58) are baked in as numpy arrays and folded into the
  compiled executable — the jnp analog of the reference's
  ``cudaMemcpyToSymbol`` constant upload (poseidon_cuda.cu:256-277).
- MDS coefficients are tiny ({4..26}); rows use :func:`fr.mul_small`
  (one-digit multiplier) instead of the full 512-bit schoolbook product,
  cutting the MDS cost ~6x while remaining bit-identical.
- All state values inside the permutation are reduced (< p), so round-constant
  adds and MDS accumulations use the single-conditional-subtract
  :func:`fr.add_rr` fast path (bit-identical to the wrapping add in this
  regime).  The sponge's absorb add uses the full wrapping :func:`fr.add`
  because user-supplied inputs may be any canonical 256-bit value.
- The empty-input sponge returns 0 without permuting (poseidon.cpp:103-126),
  a reference quirk preserved deliberately (SURVEY.md Appendix B.4).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from cuzk_tpu import oracle
from cuzk_tpu.field import fr

T = oracle.T
RATE = oracle.RATE
FULL_ROUNDS = oracle.FULL_ROUNDS
PARTIAL_ROUNDS = oracle.PARTIAL_ROUNDS
HALF_FULL = FULL_ROUNDS // 2


@dataclass(frozen=True)
class PoseidonParams:
    """The reference's compile-time parameter block (poseidon.hpp:8-16),
    surfaced as a frozen config.  The implemented kernels are specialized to
    the default values (as is the reference — changing them there requires a
    recompile; here it would require regenerating the round structure)."""

    state_size: int = oracle.T  # t
    capacity: int = 1
    rate: int = oracle.RATE
    full_rounds: int = oracle.FULL_ROUNDS  # R_F
    partial_rounds: int = oracle.PARTIAL_ROUNDS  # R_P
    sbox_power: int = 5  # alpha

    def __post_init__(self):
        if (
            self.state_size != oracle.T
            or self.rate != oracle.RATE
            or self.full_rounds != oracle.FULL_ROUNDS
            or self.partial_rounds != oracle.PARTIAL_ROUNDS
            or self.sbox_power != 5
        ):
            raise ValueError(
                "only the reference parameter set (t=3, r=2, R_F=8, R_P=56, "
                "alpha=5) is supported, matching the reference's "
                "compile-time constants"
            )


DEFAULT_PARAMS = PoseidonParams()

DS_SINGLE = oracle.DS_SINGLE
DS_PAIR = oracle.DS_PAIR
DS_MULTIPLE = oracle.DS_MULTIPLE

# Round constants as [64, 3, 16] uint32 digit arrays (poseidon.cpp:33-44),
# grouped per round for the scan phases.
RC_DIGITS = fr.ints_to_array(oracle.RC).reshape(
    FULL_ROUNDS + PARTIAL_ROUNDS, T, fr.NDIGITS
)
# Round schedule: 4 full / 56 partial / 4 full (poseidon.cpp:60-87).
_IS_FULL = np.array(
    [r < HALF_FULL or r >= HALF_FULL + PARTIAL_ROUNDS for r in range(64)],
    dtype=bool,
)

# 3x3 MDS matrix, row-major (poseidon.cpp:46-58). Python ints: consumed as
# static one-digit multipliers by fr.mul_small.
MDS = oracle.MDS


# MDS gather/coefficient tables for the stacked layer: product q = 3*i + j
# multiplies state row j by coefficient MDS[3*i + j]; the row-major flat
# order makes the [.., 9, 16] product tensor reshape directly to
# [.., 3(i), 3(j), 16].
_MDS_SRC_ROW = np.array([j for _ in range(T) for j in range(T)], np.int32)
_MDS_COEFF = np.array(MDS, np.uint32)


def _mds_layer(s):
    """new_s[i] = sum_j MDS[i][j] * s[j] with the reference's add/mul
    semantics (poseidon.cpp:148-167) on a STACKED ``[..., 3, 16]`` state.

    All 9 coefficient products run as ONE :func:`fr.mul_small` over a
    ``[..., 9, 16]`` gather of the state rows — the multiply traces once
    instead of nine times, which cuts the permutation's XLA program size
    (and with it the minutes-scale CPU-backend compile) ~3x.  The j-axis
    accumulation uses the oracle's left-to-right add order (all operands
    reduced, where the wrapping add is exact modular addition — order-
    independent, but kept identical anyway)."""
    prods = fr.mul_small(s[..., _MDS_SRC_ROW, :], _MDS_COEFF)
    p = prods.reshape(prods.shape[:-2] + (T, T, fr.NDIGITS))
    acc = fr.add_rr(p[..., 0, :], p[..., 1, :])
    return fr.add_rr(acc, p[..., 2, :])


# Round r's constant paired with round r-1's MDS output: the scan body is
# sbox -> MDS -> add RC[r+1], with round 0's RC-add hoisted out (it is the
# only add whose left operand may be unreduced) and a zero constant after the
# final round (add_rr(x, 0) == x bit-exactly for reduced x).
_RC_NEXT = np.concatenate(
    [RC_DIGITS[1:], np.zeros((1, T, fr.NDIGITS), np.uint32)], axis=0
)


def _permute_stacked(s, full_round0_add: bool = False):
    """64-round permutation on a STACKED ``[..., 3, 16]`` digit array.

    ONE scan over all 64 rounds with a ``lax.cond`` full/partial S-box
    switch: the round body compiles once, and within it each fr op traces
    once over the stacked state (a 3x smaller XLA program than the previous
    per-row unrolled form — this is what keeps the CPU-backend compile of a
    sponge executable tens of seconds instead of minutes).

    ``full_round0_add``: the sponge feeds reduced state (< p), where
    ``add_rr``'s single conditional subtract equals the oracle add exactly.
    The public raw permutation may see arbitrary canonical 256-bit state
    (the reference's batch_permutation adds with full reduction) — it passes
    True so round 0 uses the oracle's full wrap-at-2^256 add.

    The full/partial S-box switch is a SELECT, not a ``lax.cond``: the body
    computes power5 on the whole stacked state and keeps rows 1..2 unchanged
    in partial rounds.  A cond would compile two power5 programs (one per
    branch) — on the XLA:CPU backend, where compile cost is per-op and the
    sponge was minutes-slow, one traced power5 halves the round body.  The
    extra runtime multiplies only affect this jnp path; the GPU hot path is
    the CUDA kernel."""
    add0 = fr.add if full_round0_add else fr.add_rr
    s = add0(s, jnp.asarray(RC_DIGITS[0]))

    def step(carry, xs):
        rc_next, is_full = xs
        p5 = fr.power5(carry)
        st = jnp.where(
            is_full,
            p5,
            jnp.concatenate([p5[..., :1, :], carry[..., 1:, :]], axis=-2),
        )
        st = _mds_layer(st)
        return fr.add_rr(st, rc_next), None

    s, _ = jax.lax.scan(
        step, s, (jnp.asarray(_RC_NEXT), jnp.asarray(_IS_FULL))
    )
    return s


def _permute_tuple(s, full_round0_add: bool = False):
    """Tuple-of-rows wrapper around :func:`_permute_stacked` (sponge-internal
    state is kept as separate [..., 16] arrays)."""
    out = _permute_stacked(jnp.stack(s, axis=-2), full_round0_add)
    return tuple(out[..., i, :] for i in range(T))


@jax.jit
def _permutation_flat(state: jnp.ndarray) -> jnp.ndarray:
    return _permute_stacked(state, full_round0_add=True)


def permutation(state: jnp.ndarray) -> jnp.ndarray:
    """Poseidon permutation on ``[..., 3, 16]`` states (poseidon.cpp:60-87).
    States may be any canonical 256-bit values (round 0 adds with the full
    oracle semantics, like the reference's batch_permutation)."""
    state = jnp.asarray(state, jnp.uint32)
    batch_shape = state.shape[:-2]
    flat = state.reshape((-1, T, fr.NDIGITS))
    b = flat.shape[0]
    bp = _bucket(b)
    if bp != b:
        flat = jnp.concatenate(
            [flat, jnp.zeros((bp - b, T, fr.NDIGITS), jnp.uint32)], axis=0
        )
    out = _permutation_flat(flat)[:b]
    return out.reshape(batch_shape + (T, fr.NDIGITS))


def _sponge(inputs: jnp.ndarray, domain_separator: int) -> jnp.ndarray:
    """Sponge over ``[..., n, 16]`` inputs with a static block count
    (poseidon.cpp:103-126): ds in state[0], absorb pairs into state[1..2],
    one permutation per absorbed rate-block, squeeze state[1]."""
    n = inputs.shape[-2]
    batch_shape = inputs.shape[:-2]
    zero = jnp.zeros(batch_shape + (fr.NDIGITS,), jnp.uint32)
    if n == 0:
        # Empty input: absorb loop never runs, state[1] is still 0
        # (reference quirk, SURVEY.md Appendix B.4).
        return zero
    s0 = jnp.broadcast_to(
        jnp.asarray(fr.int_to_digits(domain_separator)), zero.shape
    )
    s = (s0, zero, zero)
    i = 0
    while i < n:
        absorbed = list(s)
        for j in range(RATE):
            if i >= n:
                break
            absorbed[1 + j] = fr.add(absorbed[1 + j], inputs[..., i, :])
            i += 1
        s = _permute_tuple(tuple(absorbed))
    return s[1]


def _sponge_dyn(inputs: jnp.ndarray, n: jnp.ndarray, ds: jnp.ndarray):
    """Width-DYNAMIC sponge: ``inputs [B, W, 16]`` zero-padded to an even
    static width W, with the true input count ``n`` and domain separator
    ``ds`` as runtime scalars.

    One executable serves every width <= W and every ds: the absorb loop
    runs ceil(n/2) dynamic iterations, and absorbing a padded zero is
    bit-exactly a no-op (the oracle add satisfies add(x, 0) == x for the
    reduced sponge state).  This is what keeps the XLA program count — and
    with it cold compile time — independent of the hash-width mix."""
    b = inputs.shape[0]
    zero = jnp.zeros((b, fr.NDIGITS), jnp.uint32)
    ds_digits = jnp.zeros((b, fr.NDIGITS), jnp.uint32).at[:, 0].set(
        ds.astype(jnp.uint32)
    )

    def block(bi, s):
        s0, s1, s2 = s
        i0 = 2 * bi
        a0 = jax.lax.dynamic_index_in_dim(inputs, i0, axis=1, keepdims=False)
        a1 = jax.lax.dynamic_index_in_dim(
            inputs, i0 + 1, axis=1, keepdims=False
        )
        s1 = fr.add(s1, a0)
        s2 = fr.add(s2, a1)
        return tuple(_permute_tuple((s0, s1, s2)))

    n_blocks = (n.astype(jnp.int32) + 1) // 2
    s = jax.lax.fori_loop(0, n_blocks, block, (ds_digits, zero, zero))
    out = s[1]
    # n == 0: no block ran, state[1] is 0 (SURVEY.md B.4) — already correct.
    return out


# ---------------------------------------------------------------------------
# Public batched APIs.
#
# Each call is normalized to a flat ``[B, n, 16]`` batch with B padded to a
# power-of-two bucket (>= 8): arbitrary leading batch shapes all reuse a
# log-bounded set of compiled executables instead of one per exact shape.
# (XLA compiles the 64-round sponge in minutes on the CPU backend — compile
# reuse, not runtime, is what this buys; zero-padding rows are sliced off.)
# ---------------------------------------------------------------------------

_sponge_flat_dyn = jax.jit(_sponge_dyn)
sponge = jax.jit(_sponge, static_argnums=1)

# Inputs are width-padded to this many absorbed elements (wider calls pad to
# the next even width): every hash_single/pair/multiple call with n <= 8
# shares ONE executable per batch bucket.
PAD_WIDTH = 8


def _bucket(b: int) -> int:
    """Next power of two >= max(b, 8)."""
    return 1 << max(3, (b - 1).bit_length()) if b > 1 else 8


def _sponge_bucketed(inputs: jnp.ndarray, ds: int) -> jnp.ndarray:
    """[..., n, 16] -> [..., 16] through the width-dynamic bucketed
    executable (see :func:`_sponge_dyn`)."""
    inputs = jnp.asarray(inputs, jnp.uint32)
    batch_shape = inputs.shape[:-2]
    n = inputs.shape[-2]
    if n == 0:
        return jnp.zeros(batch_shape + (fr.NDIGITS,), jnp.uint32)
    flat = inputs.reshape((-1, n, fr.NDIGITS))
    b = flat.shape[0]
    bp = _bucket(b)
    if bp != b:
        flat = jnp.concatenate(
            [flat, jnp.zeros((bp - b, n, fr.NDIGITS), jnp.uint32)], axis=0
        )
    w = max(PAD_WIDTH, n + (n & 1))
    if w != n:
        flat = jnp.concatenate(
            [flat, jnp.zeros((bp, w - n, fr.NDIGITS), jnp.uint32)], axis=1
        )
    out = _sponge_flat_dyn(
        flat, jnp.asarray(n, jnp.int32), jnp.asarray(ds, jnp.int32)
    )[:b]
    return out.reshape(batch_shape + (fr.NDIGITS,))


def hash_single(x: jnp.ndarray) -> jnp.ndarray:
    """Batched single-input hash, ds=1 (poseidon.cpp:89-91). [...,16]->[...,16]."""
    x = jnp.asarray(x, jnp.uint32)
    return _sponge_bucketed(x[..., None, :], DS_SINGLE)


def hash_pair(left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
    """Batched pair hash, ds=2 (poseidon.cpp:93-96)."""
    left, right = jnp.broadcast_arrays(
        jnp.asarray(left, jnp.uint32), jnp.asarray(right, jnp.uint32)
    )
    return _sponge_bucketed(jnp.stack([left, right], axis=-2), DS_PAIR)


def hash_multiple(inputs: jnp.ndarray) -> jnp.ndarray:
    """Batched n-input hash, ds=3 (poseidon.cpp:98-101). ``[..., n, 16]`` with
    static n -> ``[..., 16]``."""
    return _sponge_bucketed(inputs, DS_MULTIPLE)


# ---------------------------------------------------------------------------
# Convenience host-side helpers (ints in / ints out) for tests and CLIs.
# ---------------------------------------------------------------------------

def hash_single_int(x: int) -> int:
    return fr.array_to_ints(hash_single(fr.ints_to_array([x])))[0]


def hash_pair_int(left: int, right: int) -> int:
    return fr.array_to_ints(
        hash_pair(fr.ints_to_array([left]), fr.ints_to_array([right]))
    )[0]


def hash_multiple_int(inputs) -> int:
    if len(inputs) == 0:
        return 0
    arr = fr.ints_to_array(inputs)[None, :, :]
    return fr.array_to_ints(hash_multiple(arr))[0]
