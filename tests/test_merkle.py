"""Merkle layer tests: golden roots, oracle differentials, proof round-trips.

Mirrors the reference's tree tests (test_merkle_tree.cpp,
test_merkle_tree_cuda.cpp: root consistency, heights, proof verify,
cross-implementation checks) with hard golden vectors added.
"""

import random

import numpy as np
import pytest

from cuzk_tpu import merkle, oracle
from cuzk_tpu.field import fr

rng = random.Random(4242)


def leaves_arr(xs):
    return fr.ints_to_array(xs)


def test_golden_roots():
    assert merkle.NaryMerkleTree(leaves_arr([1, 2])).root_int() == int(
        "0x28c245bfd4d7a4d1ee6ba330337adc309f013d29c9326c28ba0d3cb47027fca6", 16
    )
    assert merkle.NaryMerkleTree(leaves_arr([1, 2, 3, 4])).root_int() == int(
        "0x236b917229eeea3ee41c637a7c3cc01f727ac1dc5108c962f564acc1d8730e44", 16
    )
    t3 = merkle.NaryMerkleTree(
        leaves_arr([1, 2, 3, 4, 5]), merkle.MerkleConfig(arity=3)
    )
    assert t3.root_int() == int(
        "0x28b819c1eb91377e70ed6e8bbb4c526b9b7ababafdcb021e135791fc4f3e25aa", 16
    )


def test_empty_hash_golden():
    assert merkle.empty_hash_int(2) == int(
        "0x194324f01efa21d2dcdd7453800fde166a852e2906e0e6de5de6921eeb77feec", 16
    )
    assert merkle.empty_hash_int(4) == int(
        "0x1c7842d7703c243a99d6e6ca4033851791b5ae206220fc8c9bcdde10e5befbdd", 16
    )
    assert merkle.empty_hash_int(8) == int(
        "0x2ca165c9c68473c20eb293f63de5986e10a90fb68f6e54bd7932e5166048445d", 16
    )


@pytest.mark.parametrize("arity,count", [(2, 5), (3, 7), (8, 10)])
def test_roots_match_oracle(arity, count):
    xs = [rng.randrange(oracle.P) for _ in range(count)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    assert tree.root_int() == oracle.merkle_root(xs, arity)
    assert tree.get_tree_height() == oracle.tree_height(count, arity)
    # every level matches the oracle
    want_levels = oracle.build_tree_levels(xs, arity)
    got_levels = [fr.array_to_ints(lv) for lv in tree.levels]
    assert got_levels == want_levels


@pytest.mark.parametrize("arity", [2, 4, 8])
def test_proof_roundtrip(arity):
    count = 16
    xs = [rng.randrange(oracle.P) for _ in range(count)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = [0, 3, count - 1]
    pos, sib = tree.generate_batch_proofs(idxs)
    leaves = tree.levels[0][np.array(idxs)]
    # batch verify against our root
    assert tree.verify_batch_proofs(pos, sib, leaves)
    # individual proofs match the oracle's proof content
    for row, i in enumerate(idxs):
        o_idx, o_path = oracle.generate_proof(
            [fr.array_to_ints(lv) for lv in tree.levels], arity, i
        )
        assert list(np.asarray(pos[row])) == o_idx
        got_sibs = [
            fr.array_to_ints(np.asarray(sib[row][lvl]))
            for lvl in range(sib.shape[1])
        ]
        assert got_sibs == o_path


def test_verify_rejects_tampered():
    xs = [rng.randrange(oracle.P) for _ in range(8)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs))
    pos, sib = tree.generate_batch_proofs([2])
    leaf = tree.levels[0][2]
    assert tree.verify_proof(pos[0], sib[0], leaf)
    # wrong leaf
    bad_leaf = fr.ints_to_array([oracle.add(xs[2], 1)])[0]
    assert not tree.verify_proof(pos[0], sib[0], bad_leaf)
    # tampered sibling
    bad_sib = np.asarray(sib[0]).copy()
    bad_sib[0, 0, 0] ^= 1
    assert not tree.verify_proof(pos[0], bad_sib, leaf)
    # wrong position
    bad_pos = np.asarray(pos[0]).copy()
    bad_pos[0] = (bad_pos[0] + 1) % 2
    assert not tree.verify_proof(bad_pos, sib[0], leaf)


def test_single_leaf_tree():
    tree = merkle.NaryMerkleTree(leaves_arr([42]))
    assert tree.get_tree_height() == 1
    assert tree.root_int() == 42
    pos, sib = tree.generate_batch_proofs([0])
    assert pos.shape == (1, 0)
    assert tree.verify_batch_proofs(pos, sib, tree.levels[0][:1])


def test_empty_tree():
    tree = merkle.NaryMerkleTree()
    assert tree.levels == []
    root = merkle.merkle_root(np.zeros((0, fr.NDIGITS), np.uint32), 2)
    assert fr.array_to_ints(root[None])[0] == oracle.empty_hash(2)
    with pytest.raises(ValueError):
        tree.get_root_hash()


def test_update_and_insert_leaf():
    xs = [rng.randrange(oracle.P) for _ in range(4)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs))
    new_val = rng.randrange(oracle.P)
    assert tree.update_leaf(1, fr.int_to_digits(new_val))
    xs2 = list(xs)
    xs2[1] = new_val
    assert tree.root_int() == oracle.merkle_root(xs2, 2)

    extra = rng.randrange(oracle.P)
    assert tree.insert_leaf(fr.int_to_digits(extra))
    assert tree.get_leaf_count() == 5
    assert tree.root_int() == oracle.merkle_root(xs2 + [extra], 2)


def test_out_of_range_proof():
    tree = merkle.NaryMerkleTree(leaves_arr([1, 2, 3, 4]))
    with pytest.raises(IndexError):
        tree.generate_proof(99)


def test_invalid_arity():
    with pytest.raises(ValueError):
        merkle.MerkleConfig(arity=1)
    with pytest.raises(ValueError):
        merkle.MerkleConfig(arity=9)


def test_optimal_arity_heuristic():
    assert merkle.optimal_arity(100) == 2
    assert merkle.optimal_arity(50_000) == 4
    assert merkle.optimal_arity(1_000_000) == 8


def test_calculate_max_leaves():
    # arity**(height-1), exact integers (merkle_tree.cpp:369-372).
    assert merkle.calculate_max_leaves(1, 2) == 1
    assert merkle.calculate_max_leaves(4, 2) == 8
    assert merkle.calculate_max_leaves(7, 8) == 8**6
    # Inverse relationship with tree_height: a full tree of max_leaves
    # has exactly that height.
    for arity in (2, 3, 8):
        for h in (1, 2, 5):
            n = merkle.calculate_max_leaves(h, arity)
            assert merkle.tree_height(n, arity) == h
    with pytest.raises(ValueError):
        merkle.calculate_max_leaves(0, 2)
    with pytest.raises(ValueError):
        merkle.calculate_max_leaves(3, 9)


def test_config_tree_height_field():
    # merkle_tree.hpp:25-31: the field exists with default 20 and is
    # advisory — the built tree's height comes from the leaf count.
    cfg = merkle.MerkleConfig(arity=4)
    assert cfg.tree_height == merkle.DEFAULT_TREE_HEIGHT == 20
    cfg = merkle.MerkleConfig(arity=4, tree_height=3)
    tree = merkle.NaryMerkleTree(leaves_arr([1, 2, 3, 4, 5]), cfg)
    assert tree.config.tree_height == 3
    assert tree.get_tree_height() == merkle.tree_height(5, 4)


def test_generate_proofs_vectorized_index_validation():
    # The range check is one numpy min/max, but the error contract is
    # unchanged: first offending index reported, IndexError subclass.
    tree = merkle.NaryMerkleTree(leaves_arr([1, 2, 3, 4]))
    with pytest.raises(IndexError, match="99"):
        tree.generate_batch_proofs([0, 99, 1])
    with pytest.raises(IndexError, match="-1"):
        tree.generate_batch_proofs([-1, 2])
    pos, sib = tree.generate_batch_proofs(np.zeros(0, np.int64))
    assert pos.shape[0] == 0


def test_update_tree_levels_range_check():
    # Module-level API must fail loudly on OOB indices (JAX would silently
    # drop the scatter): round-3 advisor finding.
    tree = merkle.NaryMerkleTree(leaves_arr([1, 2, 3, 4]))
    vals = leaves_arr([7])
    with pytest.raises(IndexError, match="4"):
        merkle.update_tree_levels(tree.levels, 2, [4], vals)
    with pytest.raises(IndexError, match="-2"):
        merkle.update_tree_levels(tree.levels, 2, [-2], vals)


def test_benchmark_tree_fills_result():
    r = merkle.benchmark_tree(64, 4, num_proofs=8)
    assert r.leaf_count == 64 and r.arity == 4
    assert r.tree_height == merkle.tree_height(64, 4) == 4
    assert r.build_time_ms > 0
    assert r.proof_time_ms > 0
    assert r.verify_time_ms > 0


def test_generate_test_leaves_matches_mt19937():
    got = merkle.generate_test_leaves(4, seed=42)
    want = oracle.generate_test_leaves(4, seed=42)
    assert fr.array_to_ints(got) == want


def test_validate_proof_structure_and_compare_trees():
    xs = [rng.randrange(oracle.P) for _ in range(4)]
    t1 = merkle.NaryMerkleTree(leaves_arr(xs))
    t2 = merkle.NaryMerkleTree(leaves_arr(xs))
    t3 = merkle.NaryMerkleTree(leaves_arr(xs[:2]))
    assert merkle.compare_trees(t1, t2)
    assert not merkle.compare_trees(t1, t3)
    pos, sib = t1.generate_batch_proofs([1])
    assert merkle.validate_proof_structure(pos[0], sib[0], 2)
    assert not merkle.validate_proof_structure(pos[0], sib[0], 3)
    out = merkle.print_tree(t1)
    assert "root" in out and "level 0" in out
    assert merkle.print_tree(merkle.NaryMerkleTree()) == "(empty tree)"


def test_build_batch_trees_equal_sizes_fused():
    sets = [
        leaves_arr([rng.randrange(oracle.P) for _ in range(4)]) for _ in range(3)
    ]
    trees = merkle.build_batch_trees(sets, arity=2)
    assert len(trees) == 3
    for ls, t in zip(sets, trees):
        assert t.root_int() == oracle.merkle_root(fr.array_to_ints(ls), 2)
        # proofs from fused builds still verify
        pos, sib = t.generate_batch_proofs([0])
        assert t.verify_batch_proofs(pos, sib, t.levels[0][:1])


def test_build_batch_trees_mixed_sizes():
    sets = [
        leaves_arr([rng.randrange(oracle.P) for _ in range(k)]) for k in (2, 4)
    ]
    trees = merkle.build_batch_trees(sets, arity=2)
    for ls, t in zip(sets, trees):
        assert t.root_int() == oracle.merkle_root(fr.array_to_ints(ls), 2)


@pytest.mark.gpu
def test_fused_build_matches_host_driven_gpu():
    """On the GPU: the one-dispatch fused build (_build_levels_fused) must
    agree level-for-level with the host-driven loop and the oracle."""
    import jax.numpy as jnp

    for arity, count in [(2, 5), (4, 50), (3, 28)]:
        xs = [rng.randrange(oracle.P) for _ in range(count)]
        leaves = leaves_arr(xs)
        padded = merkle.padded_leaf_count(count, arity)
        e = np.array(merkle._empty_hash_digits(arity), np.uint32)
        parts = [np.asarray(leaves, np.uint32)]
        if padded > count:
            parts.append(np.broadcast_to(e, (padded - count, fr.NDIGITS)))
        work = jnp.asarray(np.concatenate(parts, axis=0), jnp.uint32)
        fused = merkle._build_levels_fused(work, arity)
        # host-driven twin on the same backend
        want = merkle._build_levels(work, arity)
        assert len(fused) == len(want)
        for a, b in zip(fused, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # root matches the python-int oracle
        assert fr.array_to_ints(np.asarray(fused[-1]))[0] == oracle.merkle_root(
            xs, arity
        )


def test_save_load_tree_roundtrip(tmp_path):
    """Checkpoint/resume: a saved tree reloads with identical levels, root,
    and proof behavior (SURVEY.md §5's optional persistence subsystem)."""
    xs = [rng.randrange(oracle.P) for _ in range(10)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity=4))
    path = str(tmp_path / "tree.npz")
    merkle.save_tree(tree, path)
    loaded = merkle.load_tree(path)
    assert loaded.config.arity == 4
    assert loaded.get_leaf_count() == 10
    assert merkle.compare_trees(tree, loaded)
    assert loaded.root_int() == tree.root_int()
    pos, sib = loaded.generate_batch_proofs([0, 7, 9])
    import jax.numpy as jnp

    proved = loaded.levels[0][jnp.asarray([0, 7, 9])]
    assert bool(loaded.verify_batch_proofs(pos, sib, proved))

    with pytest.raises(ValueError):
        merkle.save_tree(merkle.NaryMerkleTree(), path)


def test_load_tree_verify_flag(tmp_path):
    """load_tree(verify=True) accepts an honest file and rejects a
    tampered one — including a tampered INTERMEDIATE level whose root is
    untouched (a root-only check would miss it)."""
    xs = [rng.randrange(oracle.P) for _ in range(9)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity=2))
    path = str(tmp_path / "tree.npz")
    merkle.save_tree(tree, path)
    loaded = merkle.load_tree(path, verify=True)
    assert loaded.root_int() == tree.root_int()

    with np.load(path) as data:
        payload = {k: data[k].copy() for k in data.files}
    payload["level_1"][0, 0] ^= 1  # intermediate level, root untouched
    bad = str(tmp_path / "bad.npz")
    np.savez_compressed(bad, **payload)
    from cuzk_tpu.utils import errors

    with pytest.raises(errors.ComputationError):
        merkle.load_tree(bad, verify=True)
    # without the flag, the tampered file loads (trusted-data fast path)
    assert merkle.load_tree(bad).get_leaf_count() == 9


# ---------------------------------------------------------------------------
# Deduplicated batch verification (merkle.verify_all with dedupe=True):
# must agree with the per-proof path in every case, including tampered
# batches (which exercise the merge-check fallback).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arity", [2, 3, 4, 8])
def test_dedup_verify_matches_per_proof(arity):
    xs = [rng.randrange(oracle.P) for _ in range(41)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    # overlapping + duplicate indices so chains genuinely merge
    idxs = list(range(30)) + [5, 5, 12, 29]
    pos, sib = tree.generate_batch_proofs(idxs)
    proved = tree.levels[0][np.array(idxs)]
    root = tree.get_root_hash()
    pos, sib = np.asarray(pos), np.asarray(sib)
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=False)


@pytest.mark.parametrize("arity", [2, 4])
def test_dedup_verify_rejects_tampered(arity):
    xs = [rng.randrange(oracle.P) for _ in range(33)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = list(range(24))
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos), np.asarray(sib)
    proved = np.asarray(tree.levels[0][np.array(idxs)])
    root = np.asarray(tree.get_root_hash())

    bad_leaf = proved.copy()
    bad_leaf[7, 3] ^= 1  # merge-check mismatch -> exact fallback path
    assert not merkle.verify_all(pos, sib, bad_leaf, root, arity, dedupe=True)

    bad_sib = sib.copy()
    bad_sib[3, 1, 0, 2] ^= 1
    assert not merkle.verify_all(pos, bad_sib, proved, root, arity, dedupe=True)

    bad_root = root.copy()
    bad_root[0] ^= 1
    assert not merkle.verify_all(pos, sib, proved, bad_root, arity, dedupe=True)

    bad_pos = pos.copy()
    bad_pos[2, 0] = (bad_pos[2, 0] + 1) % arity
    assert not merkle.verify_all(bad_pos, sib, proved, root, arity, dedupe=True)


def _hash_colliding_delta(i0=0, i1=1):
    """u64 word deltas (d0, d1) with salt_i0*d0 + salt_i1*d1 == 0 mod 2^64
    and (d0, d1) != 0 — added to a row's u64 words i0/i1 they change the
    bytes but preserve merkle._row_hash_u64 (its core is linear in the u64
    words; the final avalanche is a bijection).  Pick (i0, i1) to match
    where the bytes land in the hashed row: sibling rows hash from word 0;
    a level-0 CONTENT row places the sibling after the group's earlier
    columns (e.g. words 8+ when the leaf occupies column 0)."""
    s0, s1 = (int(merkle._COLUMN_SALTS[i0]), int(merkle._COLUMN_SALTS[i1]))
    d0 = 1
    d1 = (-s0 * d0 * pow(s1, -1, 1 << 64)) % (1 << 64)
    return d0, d1


def _apply_delta_row(row_u32: np.ndarray, d0: int, d1: int) -> np.ndarray:
    """Return a copy of a uint32 row with (d0, d1) added to its first two
    little-endian u64 words (mod 2^64)."""
    out = np.ascontiguousarray(row_u32.copy())
    w = out.view("<u8")
    w[0] = np.uint64((int(w[0]) + d0) % (1 << 64))
    w[1] = np.uint64((int(w[1]) + d1) % (1 << 64))
    return out


def test_dedup_schedule_rejects_crafted_hash_collision(monkeypatch):
    """The numpy fallback's row hash is linear, so collisions are
    craftable — that path must byte-confirm buckets and abort (return
    None) instead of merging distinct rows (advisor finding, round 2).
    The native grouper byte-compares on every probe, so the same inputs
    must NOT decline there — the colliding rows simply stay distinct
    groups.  Both hashed row kinds are attacked: level-0 CONTENT rows and
    upper-level sibling rows."""
    # Native path first: exact by construction, never declines on these.
    leaves = np.ones((2, 16), np.uint32)
    if merkle._native_scheduler():
        row_x = np.arange(16, dtype=np.uint32) & 0xFFFF
        row_y = row_x.copy()
        row_y[0] ^= 1
        sched = merkle._dedup_schedule(
            np.zeros((2, 1), np.int32),
            np.stack([row_x, row_y]).reshape(2, 1, 1, 16),
            leaves,
        )
        assert sched is not None and sched[4][1][0] == 2  # 2 content jobs

    monkeypatch.setattr(merkle, "_native_sched", False)

    # (a) Level-0 content collision: arity 2, pos 0 puts the sibling at
    # content words 8..15, so the delta targets salt words 8/9.
    d0, d1 = _hash_colliding_delta(8, 9)
    row_a = np.arange(16, dtype=np.uint32) & 0xFFFF
    row_b = _apply_delta_row(row_a, d0, d1)
    assert not np.array_equal(row_a, row_b)
    ca = np.concatenate([leaves[0], row_a]).reshape(1, -1)
    cb = np.concatenate([leaves[1], row_b]).reshape(1, -1)
    ha = merkle._row_hash_u64(ca.view(np.uint8))
    hb = merkle._row_hash_u64(cb.view(np.uint8))
    assert ha[0] == hb[0]  # the crafted content collision is real
    positions = np.zeros((2, 1), np.int32)
    siblings = np.stack([row_a, row_b]).reshape(2, 1, 1, 16)
    assert merkle._dedup_schedule(positions, siblings, leaves) is None

    # (b) Upper-level sibling-row collision (hashed from word 0).
    d0, d1 = _hash_colliding_delta(0, 1)
    row_b0 = _apply_delta_row(row_a, d0, d1)
    ha = merkle._row_hash_u64(row_a.reshape(1, -1).view(np.uint8))
    hb = merkle._row_hash_u64(row_b0.reshape(1, -1).view(np.uint8))
    assert ha[0] == hb[0]
    positions = np.zeros((2, 2), np.int32)
    shared = np.zeros((2, 1, 16), np.uint32)  # identical level-0 rows
    siblings = np.stack(
        [
            np.stack([shared[0], row_a.reshape(1, 16)]),
            np.stack([shared[1], row_b0.reshape(1, 16)]),
        ]
    )  # [2, 2, 1, 16]
    assert merkle._dedup_schedule(positions, siblings, leaves) is None


def test_dedup_schedule_partition_matches_bruteforce():
    """The schedule's grouping must EQUAL the mathematical partition
    (level-0: identical reconstructed content groups; level L: identical
    (positions[:, L:], siblings[:, L:]) suffixes) up to job relabeling.
    Exercises both fast paths added in round 4: duplicate-only bucket
    confirmation (tiny alphabet forces many duplicate rows) and the
    saturation early-exit (a block of all-distinct proofs saturates the
    suffix partition mid-walk, switching lower levels to identity
    numbering)."""
    rng_np = np.random.default_rng(3)
    k, arity, h = 400, 3, 5
    positions = rng_np.integers(0, arity, (k, h)).astype(np.int32)
    # Tiny alphabet => heavy row duplication at every level.
    siblings = rng_np.integers(0, 4, (k, h, arity - 1, 16)).astype(np.uint32)
    leaves = rng_np.integers(0, 4, (k, 16)).astype(np.uint32)
    # Make the top half share whole suffixes and the bottom half fully
    # distinct (forces saturation once the distinct block dominates).
    positions[200:, 2:] = positions[:200, 2:]
    siblings[200:, 2:] = siblings[:200, 2:]
    siblings[:200, 0, 0, 0] = np.arange(200, dtype=np.uint32) + 10

    sched = merkle._dedup_schedule(positions, siblings, leaves)
    assert sched is not None
    content_b, j0, upper, m1, (keys, counts, parents) = sched
    sib_flat = siblings.reshape(k, h, -1)

    def part_eq(ref_labels, got_labels):
        pairs = set(zip(map(int, ref_labels), map(int, got_labels)))
        return (
            len(pairs)
            == len(set(map(int, ref_labels)))
            == len(set(map(int, got_labels)))
        )

    # Level-0 content partition (brute force).
    pos0 = positions[:, 0]
    content = np.empty((k, arity, 16), np.uint32)
    j = np.arange(arity - 1)
    col = j[None, :] + (j[None, :] >= pos0[:, None])
    content[np.arange(k)[:, None], col] = siblings[:, 0]
    content[np.arange(k), pos0] = leaves
    crows = [tuple(r) for r in content.reshape(k, -1)]
    seen: dict = {}
    ref0 = [seen.setdefault(r, len(seen)) for r in crows]
    assert part_eq(ref0, j0)
    # Every proof's job row holds exactly its reconstructed group bytes.
    assert all(
        tuple(content_b[int(j0[i])].ravel()) == crows[i] for i in range(k)
    )

    # Suffix partitions, every level (brute force tuple keys).
    for L in range(1, h):
        seen = {}
        ref = [
            seen.setdefault(
                tuple(positions[i, L:]) + tuple(sib_flat[i, L:].ravel()),
                len(seen),
            )
            for i in range(k)
        ]
        if L == 1:
            assert part_eq(ref, m1)
        # The isolation chain map must carry the same partition, and the
        # actual (unbucketed) counts must match the true class counts.
        assert part_eq(ref, keys[L])
        n_true = len(set(ref))
        assert counts[L] == n_true
        # Job counts must equal the true class counts at every level
        # (bucketed arrays pad with copies of job 0; count the distinct
        # entering states actually scheduled).
        assert upper[L - 1][1].shape[0] == merkle._job_bucket(n_true)
    # Parent maps: each level-L job's parent is its members' level-L+1 job.
    for ell, par in parents.items():
        for i in range(k):
            assert int(par[int(keys[ell][i])]) == int(keys[ell + 1][i])

    # Case (b): distinct TOP-level rows saturate the suffix partition at
    # L = h-1, so every lower level takes the identity early-exit; the
    # grouping must still be the (all-singleton) true partition.
    siblings_b = siblings.copy()
    siblings_b[:, h - 1, 0, 0] = np.arange(k, dtype=np.uint32) + 100
    sched_b = merkle._dedup_schedule(positions, siblings_b, leaves)
    assert sched_b is not None
    _, _, upper_b, m1_b, _iso_b = sched_b
    # All-singleton at every suffix level: k jobs (bucketed) per level,
    # and m1 is a bijection over proofs.
    for L in range(1, h):
        assert upper_b[L - 1][1].shape[0] == merkle._job_bucket(k)
    assert len(set(map(int, m1_b))) == k
    # The schedule must still verify end-to-end semantics: each level-1
    # job's entering index is its own proof's level-0 job.
    ent1 = upper_b[0][0]
    j0_b = sched_b[1]
    reps_order = {int(m1_b[i]): int(j0_b[i]) for i in range(k)}
    assert all(int(ent1[m]) == j for m, j in reps_order.items())


def test_dedup_verify_sound_under_crafted_collision():
    """End-to-end soundness: an invalid proof whose top-level sibling row
    hash-collides with a valid proof's must NOT be accepted by the deduped
    path (it falls back to exact per-proof verification)."""
    arity = 2
    xs = [rng.randrange(oracle.P) for _ in range(16)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = [0, 0, 5, 9]
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos), np.asarray(sib).copy()
    proved = np.asarray(tree.levels[0][np.array(idxs)])
    root = np.asarray(tree.get_root_hash())
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    # Tamper proof 1's top-level sibling row, preserving its row hash:
    # under hash-only grouping it would silently merge with proof 0's
    # (identical) suffix and verify; exact grouping must reject the batch.
    d0, d1 = _hash_colliding_delta()
    top = sib.shape[1] - 1
    flat = sib[1, top].reshape(-1)
    sib[1, top] = _apply_delta_row(flat, d0, d1).reshape(sib[1, top].shape)
    got = merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    want = merkle.verify_all(pos, sib, proved, root, arity, dedupe=False)
    assert got == want == False  # noqa: E712


def test_dedup_range_gate_rejects_oversized_digits():
    """The dedup upload packs two 16-bit digits per word; a crafted sibling
    digit d + 2^16 would truncate back to the valid d and verify.  The
    range gate must route such batches to the exact path, which rejects
    them."""
    arity = 2
    xs = [rng.randrange(oracle.P) for _ in range(16)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = list(range(8))
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos), np.asarray(sib).copy()
    proved = np.asarray(tree.levels[0][np.array(idxs)])
    root = np.asarray(tree.get_root_hash())
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    sib[3, 1, 0, 2] += np.uint32(1 << 16)  # aliases the valid digit mod 2^16
    got = merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    want = merkle.verify_all(pos, sib, proved, root, arity, dedupe=False)
    assert got == want == False  # noqa: E712


def test_dedup_gate_declines_arity_above_8():
    """The jp word packs pos0 in 3 bits (reference MAX_ARITY=8,
    merkle_tree.hpp:20); a direct _dedup_pack call with arity > 8 must
    decline (return None) so verify_all falls to the exact path instead
    of silently mis-decoding j0/pos0 (round-4 advisor finding)."""
    k, h, arity = 8, 2, 9
    pos = np.zeros((k, h), np.int32)
    sib = np.zeros((k, h, arity - 1, 16), np.uint32)
    leaves = np.zeros((k, 16), np.uint32)
    root = np.zeros(16, np.uint32)
    assert merkle._dedup_pack(pos, sib, leaves, root, arity) is None
    # the reference's full arity domain still packs
    sib8 = np.zeros((k, h, 7, 16), np.uint32)
    assert merkle._dedup_pack(pos, sib8, leaves, root, 8) is not None


def test_dedup_verify_duplicate_full_suffix_conflict():
    """Two proofs with identical (positions, siblings) but different claimed
    leaves: the level-0 merge check must catch the conflict and the result
    must equal per-proof semantics."""
    arity = 2
    xs = [rng.randrange(oracle.P) for _ in range(8)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = [3] * 4 + list(range(8))
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos), np.asarray(sib)
    proved = np.asarray(tree.levels[0][np.array(idxs)])
    root = np.asarray(tree.get_root_hash())
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
    conflicted = proved.copy()
    conflicted[1, 0] ^= 1  # one of the duplicate-index proofs lies
    got = merkle.verify_all(pos, sib, conflicted, root, arity, dedupe=True)
    want = merkle.verify_all(pos, sib, conflicted, root, arity, dedupe=False)
    assert got == want == False  # noqa: E712


def test_dedup_gate_rejects_out_of_range_positions():
    """Positions are attacker-controlled and the dedup suffix key packs
    them into 8 bits ((c1 << 8) | pos): pos >= arity (e.g. pos + 256) or
    negative positions must route to the exact per-proof path, which
    rejects them (round-3 review finding)."""
    arity = 2
    xs = [rng.randrange(oracle.P) for _ in range(16)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = [0, 0, 5, 9]
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos).copy(), np.asarray(sib)
    proved = np.asarray(tree.levels[0][np.array(idxs)])
    root = np.asarray(tree.get_root_hash())
    for bad in (pos[1, -1] + 256, -1):
        p2 = pos.copy()
        p2[1, -1] = bad  # proof 1 shares proof 0's suffix hash otherwise
        got = merkle.verify_all(p2, sib, proved, root, arity, dedupe=True)
        want = merkle.verify_all(p2, sib, proved, root, arity, dedupe=False)
        assert got == want == False  # noqa: E712


def test_dedup_content_merges_leaf_groups():
    """Level-0 jobs are content-keyed (round 4): proving every leaf of a
    tree must yield exactly one level-0 job per leaf GROUP (the arity
    sibling proofs share one reconstructed group), not one per proof."""
    arity, n = 4, 64
    xs = [rng.randrange(oracle.P) for _ in range(n)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = np.arange(n)
    pos, sib = tree.generate_batch_proofs(idxs)
    pos, sib = np.asarray(pos, np.int32), np.asarray(sib, np.uint32)
    proved = np.asarray(tree.levels[0])[idxs]
    root = np.asarray(tree.get_root_hash())
    wire = merkle._dedup_pack(pos, sib, proved, root, arity)
    assert wire.sizes[0] == merkle._job_bucket(n // arity)  # 16 groups, not 64
    # Upper levels stay suffix-keyed: 64 proofs -> 16 L1 jobs, 4 L2 jobs.
    assert wire.sizes[1] == merkle._job_bucket(16)
    assert wire.sizes[2] == merkle._job_bucket(4)
    assert merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)


def test_dedup_value_table():
    """The wire dedups every 256-bit value — claimed leaves, content
    members, sibling nodes — into one byte-confirmed table (round 5).
    For a duplicate-heavy batch (the reference's own 5K x 1024 benchmark
    shape) the unique values are exactly the n leaves plus the internal
    nodes, the upload shrinks far below the raw proofs, and verification
    still accepts valid proofs while rejecting a tampered sibling and a
    tampered claimed leaf (the index-compare leaf-binding check)."""
    arity, n = 4, 64
    xs = [rng.randrange(oracle.P) for _ in range(n)]
    leaves = leaves_arr(xs)
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = np.arange(600) % n  # each leaf claimed ~9x
    pos, sib = tree.generate_batch_proofs(idx)
    pos_np = np.asarray(pos, np.int32)
    sib_np = np.asarray(sib, np.uint32)
    lv = np.asarray(leaves)[idx]
    root = np.asarray(tree.get_root_hash(), np.uint32)
    wire = merkle._dedup_pack(pos_np, sib_np, lv, root, arity)
    # unique values = 64 leaves + 16 level-1 nodes + 4 level-2 nodes = 84
    assert wire.tb == merkle._table_bucket(84)
    assert wire.lm16  # table and level-1 job count both fit 16 bits
    # the whole wire is far smaller than the raw proof tensors it encodes
    assert wire.packed.nbytes < (sib_np.nbytes + lv.nbytes) // 4
    assert bool(merkle.verify_all(pos_np, sib_np, lv, root, arity, dedupe=True))
    bad_sib = sib_np.copy()
    bad_sib[5, 0, 0, 0] ^= 1
    assert not bool(
        merkle.verify_all(pos_np, bad_sib, lv, root, arity, dedupe=True)
    )
    bad_lv = lv.copy()
    bad_lv[7, 0] ^= 1
    assert not bool(
        merkle.verify_all(pos_np, sib_np, bad_lv, root, arity, dedupe=True)
    )


def test_dedup_isolation_pins_failing_proof(monkeypatch):
    """One tampered proof in a valid batch: verify_each must (a) equal the
    exact per-proof path element-wise, (b) report exactly the tampered
    index, and (c) re-verify only the tiny suspect subset — never the
    whole batch (round-4 verdict item 4: the reference's kernel is
    per-proof and never pays twice)."""
    arity, n = 4, 64
    xs = [rng.randrange(oracle.P) for _ in range(n)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idx = np.arange(256) % n
    pos, sib = tree.generate_batch_proofs(idx)
    pos_np = np.asarray(pos, np.int32)
    sib_np = np.asarray(sib, np.uint32)
    lv = np.asarray(tree.levels[0])[idx]
    root = np.asarray(tree.get_root_hash(), np.uint32)
    bad_lv = lv.copy()
    bad_lv[17, 0] ^= 1

    calls = []
    real = merkle.verify_proofs

    def spy(p, s, l, r, a):
        calls.append(int(np.asarray(p).shape[0]))
        return real(p, s, l, r, a)

    monkeypatch.setattr(merkle, "verify_proofs", spy)
    got = np.asarray(merkle.verify_each(pos_np, sib_np, bad_lv, root, arity, dedupe=True))
    want = np.asarray(real(pos_np, sib_np, bad_lv, root, arity))
    np.testing.assert_array_equal(got, want)
    assert not got[17] and got.sum() == len(got) - 1
    # the exact pass saw only the suspect subset, not the 256-proof batch
    assert calls and max(calls) <= 8

    # a wrong ROOT is decided by the dedup chain alone: check-clean
    # chains' recomputations ARE the proofs' own, so no exact pass runs
    calls.clear()
    bad_root = root.copy()
    bad_root[0] ^= 1
    got = np.asarray(
        merkle.verify_each(pos_np, sib_np, lv, bad_root, arity, dedupe=True)
    )
    assert not got.any() and calls == []


def test_dedup_fuzz_matches_exact_path():
    """Randomized differential: for random trees, index multisets, and
    tamper patterns (none / leaf / sibling / position / root), the deduped
    verdict must equal the exact per-proof path's verdict."""
    frng = random.Random(0xFEED)
    for trial in range(6):  # ~4s/trial on the 1-core CPU backend
        arity = frng.choice([2, 3, 4, 8])
        n = frng.randrange(2, 40)
        xs = [frng.randrange(oracle.P) for _ in range(n)]
        tree = merkle.NaryMerkleTree(
            leaves_arr(xs), merkle.MerkleConfig(arity)
        )
        k = frng.randrange(2, 24)
        idxs = [frng.randrange(n) for _ in range(k)]
        pos, sib = tree.generate_batch_proofs(idxs)
        pos = np.asarray(pos).copy()
        sib = np.asarray(sib).copy()
        proved = np.asarray(tree.levels[0][np.array(idxs)]).copy()
        root = np.asarray(tree.get_root_hash()).copy()
        h = pos.shape[1]
        tamper = frng.choice(["none", "leaf", "sib", "pos", "root"])
        if tamper == "leaf":
            proved[frng.randrange(k), frng.randrange(16)] ^= 1
        elif tamper == "sib" and h:
            sib[
                frng.randrange(k), frng.randrange(h),
                frng.randrange(max(arity - 1, 1)), frng.randrange(16),
            ] ^= 1
        elif tamper == "pos" and h:
            r, c = frng.randrange(k), frng.randrange(h)
            pos[r, c] = (pos[r, c] + frng.randrange(1, arity)) % arity
        elif tamper == "root":
            root[frng.randrange(16)] ^= 1
        got = merkle.verify_all(pos, sib, proved, root, arity, dedupe=True)
        want = merkle.verify_all(pos, sib, proved, root, arity, dedupe=False)
        assert got == want, (
            f"trial {trial}: dedup={got} exact={want} "
            f"(arity={arity} n={n} k={k} tamper={tamper})"
        )


@pytest.mark.parametrize("arity,n", [(2, 11), (4, 16), (8, 21)])
def test_update_leaves_incremental_matches_rebuild(arity, n):
    """Batched incremental updates (O(k*h) path rehash — beyond-parity vs
    the reference's full rebuild) must produce bit-identical levels."""
    xs = [rng.randrange(oracle.P) for _ in range(n)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    idxs = [0, n - 1, n // 2]  # includes the padded-boundary group
    vals = [rng.randrange(oracle.P) for _ in idxs]
    assert tree.update_leaves(idxs, leaves_arr(vals))
    xs2 = list(xs)
    for i, v in zip(idxs, vals):
        xs2[i] = v
    rebuilt = merkle.NaryMerkleTree(
        leaves_arr(xs2), merkle.MerkleConfig(arity)
    )
    for got, want in zip(tree.levels, rebuilt.levels):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert tree.root_int() == oracle.merkle_root(xs2, arity)


def test_update_leaves_rejects_bad_inputs():
    xs = [rng.randrange(oracle.P) for _ in range(6)]
    tree = merkle.NaryMerkleTree(leaves_arr(xs))
    root_before = tree.root_int()
    v = leaves_arr([1])
    assert not tree.update_leaves([1, 1], leaves_arr([1, 2]))  # duplicates
    assert not tree.update_leaves([6], v)  # out of range
    assert not tree.update_leaves([-1], v)
    assert not tree.update_leaves([], np.zeros((0, 16), np.uint32))
    # one values row for many indices: must refuse, never broadcast
    assert not tree.update_leaves([0, 1, 2], leaves_arr([7]))
    with pytest.raises(ValueError):
        merkle.update_tree_levels(tree.levels, 2, [0, 1, 2], leaves_arr([7]))
    assert not merkle.NaryMerkleTree().update_leaves([0], v)  # empty tree
    assert tree.root_int() == root_before  # untouched on every rejection


@pytest.mark.parametrize("arity", [2, 4])
def test_insert_leaf_incremental_into_padded_slot(arity):
    """Appending into a free padded slot takes the O(height) path and must
    match a from-scratch build (and the oracle) exactly, including the
    follow-up insert that exhausts capacity and rebuilds."""
    xs = [rng.randrange(oracle.P) for _ in range(5)]  # padded to 8/16
    tree = merkle.NaryMerkleTree(leaves_arr(xs), merkle.MerkleConfig(arity))
    for _ in range(4):  # crosses the capacity boundary for arity 2
        v = rng.randrange(oracle.P)
        assert tree.insert_leaf(fr.int_to_digits(v))
        xs.append(v)
        assert tree.get_leaf_count() == len(xs)
        assert tree.root_int() == oracle.merkle_root(xs, arity)
        rebuilt = merkle.NaryMerkleTree(
            leaves_arr(xs), merkle.MerkleConfig(arity)
        )
        for got, want in zip(tree.levels, rebuilt.levels):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
