"""Exact Python-integer oracle for the cuZK reference semantics.

This module is the *specification* for the whole framework: every accelerated
path (pure-jnp vectorized field ops, the CUDA kernel, sharded Merkle builds)
must agree with these functions bit-for-bit.

The semantics replicated here are those of the reference CPU implementation
(`/root/reference/src/poseidon/field_arithmetic.cpp`,
`/root/reference/src/poseidon/poseidon.cpp`,
`/root/reference/src/merkle_tree/merkle_tree.cpp`), which were verified against
the compiled C++ sources (see SURVEY.md Appendix A).  Two deliberate quirks of
the reference are preserved because "bit-exact vs the reference" is the
contract (SURVEY.md Appendix A/B):

1. ``mul`` is a *truncated k-fold* 512->256-bit reduction
   (field_arithmetic.cpp:250-330), not true modular multiplication: the
   ``(mh*k) >> 256`` term is dropped, and additions wrap at 2**256.
2. The empty-input sponge returns 0 (poseidon.cpp:103-126).

The CUDA-side ``k`` constant bug (+4, cuda_field_element.cuh:314) is NOT
replicated: the CPU value of ``k = 2**256 mod p`` is the oracle
(SURVEY.md Appendix B.1).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

# BN254 scalar field modulus (field_arithmetic.cpp:12-17).
P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# k = 2**256 mod p — the CPU constant (field_arithmetic.cpp:257-258).
K = (1 << 256) % P
assert K == 0x0E0A77C19A07DF2F666EA36F7879462E36FC76959F60CD29AC96341C4FFFFFFB
# 256-bit wrap mask.
M256 = (1 << 256) - 1

ZERO = 0
ONE = 1
TWO = 2


# ---------------------------------------------------------------------------
# Field arithmetic (L1) — field_arithmetic.cpp semantics
# ---------------------------------------------------------------------------

def red(a: int) -> int:
    """Subtractive reduction: repeatedly subtract p (field_arithmetic.cpp:244-248).

    For a < 2**256 this terminates in at most 5 subtractions
    (floor((2**256-1)/p) == 5).
    """
    while a >= P:
        a -= P
    return a


def add(a: int, b: int) -> int:
    """Modular add that WRAPS at 2**256 before reducing (field_arithmetic.cpp:172-182).

    The wrap is semantically load-bearing inside ``reduce_512``; for reduced
    operands (a, b < p < 2**254) it never triggers and the op is exact.
    """
    return red((a + b) & M256)


def sub(a: int, b: int) -> int:
    """Modular subtract (field_arithmetic.cpp:184-219).

    If a < b the modulus is pre-added once (dropping any 2**256 carry); the
    borrow-subtract also drops a final borrow, matching the 4x64-limb code.
    """
    if a < b:
        a = (a + P) & M256
    return (a - b) & M256


def reduce_512(prod: int) -> int:
    """The reference's truncated-fold 512->256 reduction (field_arithmetic.cpp:250-330).

    NOT true ``prod mod p``: when ``mh != 0`` the term ``(mh*k) >> 256`` is
    dropped entirely, and the combining adds wrap at 2**256.  This is the
    bit-exactness contract (SURVEY.md Appendix A).
    """
    low, high = prod & M256, prod >> 256
    if high == 0:
        return red(low)
    m = high * K
    hc, mh = m & M256, m >> 256
    if mh != 0:
        hc = add(hc, (mh * K) & M256)
    return add(low, hc)


def mul(a: int, b: int) -> int:
    """Field multiply: exact 512-bit product + truncated reduction
    (field_arithmetic.cpp:221-238 + :250-330)."""
    return reduce_512(a * b)


def square(a: int) -> int:
    """field_arithmetic.cpp:240-242."""
    return mul(a, a)


def power5(a: int) -> int:
    """a^5 = ((a^2)^2) * a (field_arithmetic.cpp:332-338)."""
    a2 = mul(a, a)
    a4 = mul(a2, a2)
    return mul(a4, a)


# ---------------------------------------------------------------------------
# Poseidon (L2) — poseidon.cpp semantics; t=3, c=1, r=2, R_F=8, R_P=56, x^5
# ---------------------------------------------------------------------------

T = 3
RATE = 2
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 56
TOTAL_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
NUM_ROUND_CONSTANTS = TOTAL_ROUNDS * T  # 192

# Domain separators (poseidon.cpp:89-101).
DS_SINGLE = 1
DS_PAIR = 2
DS_MULTIPLE = 3

# Fixed 3x3 MDS matrix, row-major (poseidon.cpp:46-58).
MDS = (7, 23, 8, 26, 5, 4, 15, 20, 9)

_RC_MUL = 0x123456789ABCDEF
_RC_ADD = 0x987654321


def round_constants() -> List[int]:
    """RC[i] = add(mul(i+1, 0x123456789ABCDEF), i*0x987654321)
    (poseidon.cpp:33-44).  Generation stays in the exact regime, so these
    equal the true modular values."""
    return [add(mul(i + 1, _RC_MUL), i * _RC_ADD) for i in range(NUM_ROUND_CONSTANTS)]


RC = round_constants()


def permutation(state: Sequence[int]) -> List[int]:
    """64-round Poseidon permutation: 4 full / 56 partial / 4 full
    (poseidon.cpp:60-87)."""
    st = list(state)
    assert len(st) == T
    r = 0

    def rnd(full: bool) -> None:
        nonlocal st, r
        st = [add(st[i], RC[T * r + i]) for i in range(T)]
        r += 1
        if full:
            st = [power5(x) for x in st]
        else:
            st = [power5(st[0]), st[1], st[2]]
        ns = []
        for i in range(T):
            acc = 0
            for j in range(T):
                acc = add(acc, mul(MDS[T * i + j], st[j]))
            ns.append(acc)
        st = ns

    half = FULL_ROUNDS // 2
    for _ in range(half):
        rnd(True)
    for _ in range(PARTIAL_ROUNDS):
        rnd(False)
    for _ in range(half):
        rnd(True)
    return st


def sponge(inputs: Sequence[int], domain_separator: int) -> int:
    """Sponge with ds in state[0], absorb into state[1..2], squeeze state[1]
    (poseidon.cpp:103-126).  Empty input => no permutation => returns 0."""
    st = [domain_separator, 0, 0]
    i = 0
    n = len(inputs)
    while i < n:
        for j in range(RATE):
            if i >= n:
                break
            st[1 + j] = add(st[1 + j], inputs[i])
            i += 1
        st = permutation(st)
    return st[1]


def hash_single(x: int) -> int:
    """poseidon.cpp:89-91 (ds=1)."""
    return sponge([x], DS_SINGLE)


def hash_pair(left: int, right: int) -> int:
    """poseidon.cpp:93-96 (ds=2)."""
    return sponge([left, right], DS_PAIR)


def hash_multiple(inputs: Sequence[int]) -> int:
    """poseidon.cpp:98-101 (ds=3)."""
    return sponge(list(inputs), DS_MULTIPLE)


# ---------------------------------------------------------------------------
# N-ary Merkle tree (L3) — merkle_tree.cpp semantics
# ---------------------------------------------------------------------------

MIN_ARITY = 2
MAX_ARITY = 8


def empty_hash(arity: int) -> int:
    """hash_multiple(arity zeros) (merkle_tree.cpp:345-357)."""
    return hash_multiple([0] * arity)


def padded_leaf_count(n: int, arity: int) -> int:
    """Next power of arity >= n, minimum 1 (merkle_tree.cpp:49-53)."""
    padded = 1
    while padded < n:
        padded *= arity
    return padded


def tree_height(leaf_count: int, arity: int) -> int:
    """Number of levels incl. leaves, ceil(log_a(n)) + 1 with exact integer
    arithmetic (the reference uses FP logs, merkle_tree.cpp:359-367; results
    agree — SURVEY.md Appendix B.9)."""
    if leaf_count <= 1:
        return 1
    padded, h = 1, 0
    while padded < leaf_count:
        padded *= arity
        h += 1
    return h + 1


def build_tree_levels(leaves: Sequence[int], arity: int) -> List[List[int]]:
    """Bottom-up level-by-level build (merkle_tree.cpp:44-100).

    Returns all levels, level[0] = padded leaves, level[-1] = [root].
    Empty input returns [] (reference leaves root_ null).
    """
    if not MIN_ARITY <= arity <= MAX_ARITY:
        raise ValueError(f"arity must be in [{MIN_ARITY},{MAX_ARITY}], got {arity}")
    if len(leaves) == 0:
        return []
    e = empty_hash(arity)
    padded = padded_leaf_count(len(leaves), arity)
    level = list(leaves) + [e] * (padded - len(leaves))
    levels = [level]
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), arity):
            group = level[i : i + arity]
            group += [e] * (arity - len(group))
            nxt.append(hash_multiple(group))
        level = nxt
        levels.append(level)
    return levels


def merkle_root(leaves: Sequence[int], arity: int) -> int:
    """Root of the tree; empty input => empty_hash(arity)
    (merkle_tree.cpp:338-343)."""
    levels = build_tree_levels(leaves, arity)
    if not levels:
        return empty_hash(arity)
    return levels[-1][0]


def generate_proof(
    levels: Sequence[Sequence[int]], arity: int, leaf_index: int
) -> Tuple[List[int], List[List[int]]]:
    """Merkle proof for one leaf: (indices, path), leaf->root order
    (merkle_tree.cpp:130-211).

    indices[lvl] = position of the current node within its arity-group;
    path[lvl] = the arity-1 sibling hashes in ascending child order.
    """
    if not levels:
        raise IndexError("empty tree")
    if leaf_index >= len(levels[0]):
        raise IndexError("leaf index out of range")
    indices: List[int] = []
    path: List[List[int]] = []
    idx = leaf_index
    for lvl in range(len(levels) - 1):
        pos = idx % arity
        group_start = (idx // arity) * arity
        siblings = [
            levels[lvl][group_start + i] for i in range(arity) if i != pos
        ]
        indices.append(pos)
        path.append(siblings)
        idx //= arity
    return indices, path


def verify_proof(
    indices: Sequence[int],
    path: Sequence[Sequence[int]],
    leaf_value: int,
    root_hash: int,
    arity: int,
) -> bool:
    """Recompute root from leaf + siblings (merkle_tree.cpp:214-254)."""
    if len(indices) != len(path):
        return False
    current = leaf_value
    for pos, siblings in zip(indices, path):
        if pos >= arity or len(siblings) != arity - 1:
            return False
        group = list(siblings[:pos]) + [current] + list(siblings[pos:])
        current = hash_multiple(group)
    return current == root_hash


# ---------------------------------------------------------------------------
# Deterministic test-leaf generation (merkle_tree.cpp:443-457)
# ---------------------------------------------------------------------------

def generate_test_leaves(count: int, seed: int = 42) -> List[int]:
    """mt19937_64(seed); one u64 draw per leaf (merkle_tree.cpp:443-457)."""
    gen = _MT19937_64(seed)
    return [gen.next() for _ in range(count)]


class _MT19937_64:
    """Minimal 64-bit Mersenne Twister matching std::mt19937_64."""

    _N, _M = 312, 156
    _MATRIX_A = 0xB5026F5AA96619E9
    _UPPER = 0xFFFFFFFF80000000
    _LOWER = 0x7FFFFFFF
    _MASK64 = (1 << 64) - 1

    def __init__(self, seed: int) -> None:
        mt = [0] * self._N
        mt[0] = seed & self._MASK64
        for i in range(1, self._N):
            mt[i] = (
                6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62)) + i
            ) & self._MASK64
        self._mt = mt
        self._index = self._N

    def next(self) -> int:
        if self._index >= self._N:
            self._generate()
        x = self._mt[self._index]
        self._index += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & self._MASK64

    def _generate(self) -> None:
        mt, N, Mm = self._mt, self._N, self._M
        for i in range(N):
            y = (mt[i] & self._UPPER) | (mt[(i + 1) % N] & self._LOWER)
            mt[i] = mt[(i + Mm) % N] ^ (y >> 1) ^ (self._MATRIX_A if y & 1 else 0)
        self._index = 0
