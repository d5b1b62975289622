"""Differential tests of the accelerated API (``cuzk_tpu.ops``) vs the oracle.

The analog of the reference's CPU-oracle/CUDA-accelerator differential
suites (test_poseidon_cuda.cpp:38-114) plus its cross-implementation
verification gate (poseidon_cuda_benchmarks.cpp:137-259): the accelerated
path must agree bit-exactly with both the oracle and the jnp reference path.

On the CPU the ``*_pallas`` functions run the jnp reference (the CUDA
kernel has no CPU mode), so these tests pin the API's semantics and the
padding/slicing around it; the kernel's own arithmetic is checked on the
CPU through its shared header (tests/test_kernel.py) and on the GPU by the
``gpu``-marked tests here and in tests/test_kernel.py.
"""

import random

import numpy as np
import pytest

from cuzk_tpu import oracle, poseidon
from cuzk_tpu.field import fr
from cuzk_tpu.ops import (
    hash_multiple_pallas,
    hash_pair_pallas,
    hash_single_pallas,
    permutation_pallas,
)

rng = random.Random(31337)


def rand_reduced(n):
    return [rng.randrange(oracle.P) for _ in range(n)]


def rand_full(n):
    return [rng.randrange(1 << 256) for _ in range(n)]


# ---------------------------------------------------------------------------
# The accelerated API
# ---------------------------------------------------------------------------

def test_pallas_permutation_golden():
    st = fr.ints_to_array([1, 2, 3]).reshape(1, 3, fr.NDIGITS)
    got = fr.array_to_ints(permutation_pallas(st)[0])
    assert got == oracle.permutation([1, 2, 3])


def test_pallas_hash_golden():
    x42 = fr.ints_to_array([42])
    assert fr.array_to_ints(hash_single_pallas(x42))[0] == oracle.hash_single(42)
    l = fr.ints_to_array([10])
    r = fr.ints_to_array([20])
    assert fr.array_to_ints(hash_pair_pallas(l, r))[0] == int(
        "0x2dd359f92d31c747e06c02b360a9f5c761777b285edcf09724efef5cbd51d9ba", 16
    )


def test_pallas_hash_pair_batch_vs_oracle():
    ls, rs = rand_reduced(32) + rand_full(8), rand_reduced(32) + rand_full(8)
    got = fr.array_to_ints(
        hash_pair_pallas(fr.ints_to_array(ls), fr.ints_to_array(rs))
    )
    assert got == [oracle.hash_pair(l, r) for l, r in zip(ls, rs)]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pallas_hash_multiple_vs_oracle(n):
    rows = [[rng.randrange(oracle.P) for _ in range(n)] for _ in range(8)]
    arr = np.stack([fr.ints_to_array(row) for row in rows])
    got = fr.array_to_ints(hash_multiple_pallas(arr))
    assert got == [oracle.hash_multiple(row) for row in rows]


def test_pallas_loop_hash_matches_repeated_application():
    """The device-side batch loop (chip-capability bench harness) is
    repeated hashing, bit-exactly: loop(x, n) == hash^n(x)."""
    from cuzk_tpu.ops import hash_pair_pallas_loop, hash_single_pallas_loop

    ls, rs = fr.ints_to_array(rand_reduced(4)), fr.ints_to_array(rand_reduced(4))
    got = fr.array_to_ints(hash_pair_pallas_loop(ls, rs, 3))
    want = [oracle.hash_pair(
        oracle.hash_pair(oracle.hash_pair(l, r), r), r)
        for l, r in zip(rand_ints(ls), rand_ints(rs))]
    assert got == want
    got_s = fr.array_to_ints(hash_single_pallas_loop(ls, 2))
    assert got_s == [
        oracle.hash_single(oracle.hash_single(x)) for x in rand_ints(ls)
    ]


def rand_ints(arr):
    return fr.array_to_ints(np.asarray(arr))


def test_pallas_matches_jnp_path():
    """Cross-implementation gate (the reference's
    verify_cuda_implementations_match, poseidon_cuda_benchmarks.cpp:137-259)."""
    ls, rs = fr.ints_to_array(rand_reduced(16)), fr.ints_to_array(rand_reduced(16))
    a = fr.array_to_ints(hash_pair_pallas(ls, rs))
    b = fr.array_to_ints(poseidon.hash_pair(ls, rs))
    assert a == b


def test_pallas_nonaligned_batch_sizes():
    for b in (1, 5, 130):
        xs = rand_reduced(b)
        got = fr.array_to_ints(hash_single_pallas(fr.ints_to_array(xs)))
        assert got == [oracle.hash_single(x) for x in xs]


def test_pallas_permutation_unreduced_states():
    """Public raw permutation on arbitrary canonical states must match the
    oracle bit-for-bit (round 0 uses the full wrap-at-2^256 add)."""
    states = [[rng.randrange(1 << 256) for _ in range(3)] for _ in range(4)]
    states.append([(1 << 256) - 1, (1 << 256) - oracle.RC[1], oracle.P])
    arr = np.stack([fr.ints_to_array(s) for s in states])
    got = fr.array_to_ints(permutation_pallas(arr).reshape(-1, fr.NDIGITS))
    want = []
    for s in states:
        want.extend(oracle.permutation(s))
    assert got == want


@pytest.mark.parametrize("arity", [2, 3, 5, 8])
def test_verify_body_level_walk(arity):
    """The one-program verifier's level walk — current node inserted at its
    proof position, siblings around it (merkle_tree.cpp:224-253) — with the
    real sponge, against the Python oracle's root recomputation, on valid
    and tampered proofs of mixed positions."""
    from cuzk_tpu import merkle
    from cuzk_tpu.ops import verify_proofs_pallas

    xs = [rng.randrange(oracle.P) for _ in range(arity * arity + 1)]
    leaves = fr.ints_to_array(xs)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = [0, 1, arity, len(xs) - 1, arity * arity - 1]
    pos, sib = tree.generate_batch_proofs(idx)
    proved = np.asarray(leaves)[idx]
    proved[2, 0] ^= 1  # one tampered leaf
    root = tree.get_root_hash()
    got = np.asarray(verify_proofs_pallas(pos, sib, proved, root, arity))
    root_int = tree.root_int()
    want = [
        oracle.verify_proof(
            [int(p) for p in np.asarray(pos)[i]],
            [fr.array_to_ints(s) for s in np.asarray(sib)[i]],
            fr.digits_to_int(proved[i]), root_int, arity,
        )
        for i in range(len(idx))
    ]
    assert list(got) == want == [True, True, False, True, True]


@pytest.mark.gpu
def test_fused_verify_vs_batch_verify_gpu():
    """On the GPU: the one-program verify (a kernel call per level) must
    agree with the per-level batched path AND the oracle on valid and
    tampered proofs (test_merkle_tree_cuda.cpp:520-620's role)."""
    import jax.numpy as jnp

    from cuzk_tpu import merkle
    from cuzk_tpu.ops import verify_proofs_pallas

    leaves = merkle.generate_test_leaves(7, seed=5)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity=2))
    idx = [0, 3, 6, 1, 5]
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][jnp.asarray(idx)]
    root = tree.get_root_hash()

    ok_fused = np.asarray(verify_proofs_pallas(pos, sib, proved, root, 2))
    assert ok_fused.shape == (len(idx),) and ok_fused.all()

    bad = np.asarray(proved).copy()
    bad[2, 0] ^= 1
    ok_fused = np.asarray(verify_proofs_pallas(pos, sib, bad, root, 2))
    assert list(ok_fused) == [True, True, False, True, True]
