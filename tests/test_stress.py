"""Stress tier: large trees and wide hash_multiple widths.

The analog of the reference's ``DISABLED_StressTestLargeTree``
(test_merkle_benchmark.cpp:220-235, 64K leaves, disabled by default) —
here opt-in via ``CUZK_STRESS=1`` on CPU (one large tree build costs
several large-bucket XLA:CPU compiles cold); the 256K-leaf variant runs
on the GPU (``gpu`` marker), and chip_smoke.py builds a 2^24-leaf tree.

The wide-width differential always runs: ``hash_multiple`` widths above
PAD_WIDTH take the ``w = n + (n & 1)`` executable path (poseidon.py),
which no other test exercises.
"""

import os
import random

import numpy as np
import pytest

from cuzk_tpu import merkle, oracle, poseidon
from cuzk_tpu.field import fr

rng = random.Random(7_654_321)

stress = pytest.mark.skipif(
    os.environ.get("CUZK_STRESS") != "1",
    reason="stress tier: opt in with CUZK_STRESS=1 (the analog of the "
    "reference's DISABLED_ prefix)",
)


@pytest.mark.parametrize("width", [9, 16, 33])
def test_hash_multiple_wide_widths_differential(width):
    """Widths > PAD_WIDTH(8) exercise the w = n+(n&1) padding path
    (poseidon.py:304) — never covered elsewhere.  Differential vs the
    python-int oracle, including the odd-width pad column."""
    batch = 3
    vals = [
        [rng.randrange(oracle.P) for _ in range(width)] for _ in range(batch)
    ]
    arr = np.stack([np.asarray(fr.ints_to_array(v)) for v in vals])
    got = fr.array_to_ints(np.asarray(poseidon.hash_multiple(arr)))
    want = [oracle.hash_multiple(v) for v in vals]
    assert got == want


@stress
def test_stress_large_tree_cpu():
    """64K-leaf arity-4 build + proof round-trip, self-consistent (the
    reference's stress test builds and verifies 100 proofs without an
    oracle cross-check; same discipline here — the tree logic is already
    oracle-differentially tested at small sizes)."""
    n = 65536  # 4^8 exactly: no padding, height 9
    arity = 4
    leaves = np.random.default_rng(42).integers(
        0, 1 << 16, (n, fr.NDIGITS), dtype=np.uint32
    )
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    assert tree.get_tree_height() == merkle.tree_height(n, arity) == 9
    idx = np.asarray(
        [0, 1, n - 1] + [rng.randrange(n) for _ in range(97)], np.int32
    )
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    root = tree.get_root_hash()
    ok = np.asarray(merkle.verify_proofs(pos, sib, proved, root, arity))
    assert ok.all()
    # Dedup path agrees at stress scale.
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    # One tampered leaf flips exactly its own slot.
    tampered = np.asarray(proved).copy()
    tampered[5, 0] ^= 1
    bad = np.asarray(merkle.verify_proofs(pos, sib, tampered, root, arity))
    assert not bad[5] and bad.sum() == len(bad) - 1
    assert not merkle.verify_all(pos, sib, tampered, root, arity, dedupe=True)


@pytest.mark.gpu
def test_stress_large_tree_gpu():
    """256K-leaf arity-8 build + proof round-trip on the GPU."""
    n = 262144  # 8^6 exactly
    arity = 8
    leaves = np.random.default_rng(43).integers(
        0, 1 << 16, (n, fr.NDIGITS), dtype=np.uint32
    )
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    assert tree.get_tree_height() == 7
    idx = np.asarray([rng.randrange(n) for _ in range(256)], np.int32)
    pos, sib = tree.generate_batch_proofs(idx)
    proved = tree.levels[0][idx]
    root = tree.get_root_hash()
    assert np.asarray(
        merkle.verify_proofs(pos, sib, proved, root, arity)
    ).all()
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
