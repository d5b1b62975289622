"""N-ary (2-8) Merkle trees on Poseidon.

Re-design of the reference's two tree implementations
(merkle_tree.cpp — CPU pointer tree; merkle_tree_cuda.cu — CUDA flat levels
with one malloc/H2D/launch/sync/D2H round-trip *per level*, :159-259).  On
the GPU the whole bottom-up level loop is traced into ONE jitted XLA
program over static shapes (``_build_levels_fused``): level ``l`` is a
``[padded/arity^l, 16]`` digit array, each level one batched
``hash_multiple`` over ``[m/a, a, 16]`` groups, and no host boundary is
crossed until the final root fetch — the reference's main structural
inefficiency removed (SURVEY.md §3.3).  Executables are keyed on the
power-of-arity padded size (a log-bounded set); empty-hash padding is one
eager concat beforehand.  On the CPU the same loop runs host-driven so
each level reuses a small per-level executable (XLA:CPU compiles of the
fused program take about height times longer); :func:`_fuse_levels` makes
that choice for every level loop here.

Semantics are bit-exact vs ``cuzk_tpu.oracle`` (merkle_tree.cpp:44-100):
- leaves padded to the next power of arity with ``empty_hash(arity) =
  hash_multiple([0]*arity)`` (merkle_tree.cpp:347-357), precomputed once per
  arity (the reference's CUDA kernel recomputes it per padded verify thread,
  merkle_tree_cuda.cu:34-42 — SURVEY.md Appendix B.8);
- proofs are per-level (position, arity-1 siblings) in leaf->root order
  (merkle_tree.cpp:130-211);
- verification recomputes the root (merkle_tree.cpp:214-254); the batch
  verifier vectorizes all proofs at once (the analog of
  ``batch_verify_proofs_kernel``, merkle_tree_cuda.cu:67-118, without the
  CSR flattening — proofs are a dense ``[k, h, a-1, 16]`` tensor).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cuzk_tpu import oracle, poseidon
from cuzk_tpu.field import fr
from cuzk_tpu.utils import errors
from cuzk_tpu.utils.device import on_gpu

MIN_ARITY = oracle.MIN_ARITY
MAX_ARITY = oracle.MAX_ARITY


_PATH_OVERRIDE: List[str] = []


@contextlib.contextmanager
def engine_path(path: str):
    """Force the hash engine for tree building/verification: ``"jnp"`` or
    ``"kernel"`` (default: the kernel, which itself runs the jnp path off
    the GPU).  Used by the benchmark's reference-vs-accelerated comparison
    (the analog of benchmark_cuda_vs_cpu_merkle, merkle_tree_cuda.cu:648-856).
    Only honored on the host-driven build/verify paths — the fused jitted
    programs key executables on shapes alone, so callers forcing a path
    must use the host-driven loops (bench does)."""
    _PATH_OVERRIDE.append(path)
    try:
        yield
    finally:
        _PATH_OVERRIDE.pop()


def _engine_hash_multiple(groups: jnp.ndarray) -> jnp.ndarray:
    """The hash engine for tree building/verification: the CUDA kernel on
    a GPU, the jnp reference path elsewhere — bit-identical either way
    (differentially tested in tests/test_pallas.py and chip_smoke.py)."""
    if _PATH_OVERRIDE and _PATH_OVERRIDE[-1] == "jnp":
        return poseidon.hash_multiple(groups)
    from cuzk_tpu.ops import hash_multiple_pallas

    return hash_multiple_pallas(groups)


def _fuse_levels() -> bool:
    """Run a level loop as one jitted program (on the GPU) or drive it
    level by level from the host (on the CPU, where XLA compile time grows
    with program size and small per-level executables are shared)."""
    return on_gpu()


# merkle_tree.hpp:20 — default config height bound (informational only here;
# the build derives height from the leaf count exactly).
DEFAULT_TREE_HEIGHT = 20


@dataclass(frozen=True)
class MerkleConfig:
    """Runtime-validated tree config (merkle_tree.hpp:17-32).

    ``tree_height`` mirrors the reference's field of the same name: a
    default/advisory height for an empty tree (merkle_tree.hpp:25-31 keeps
    it but the build derives the real height from the leaf count; so does
    :meth:`NaryMerkleTree.get_tree_height` here)."""

    arity: int = 2
    tree_height: int = DEFAULT_TREE_HEIGHT

    def __post_init__(self):
        # ValidationError subclasses ValueError, matching the reference's
        # MerkleTreeConfig validation contract (merkle_tree.hpp:24-31),
        # which validates arity only.
        errors.validate_range(self.arity, MIN_ARITY, MAX_ARITY, "arity")


@functools.lru_cache(maxsize=None)
def empty_hash_int(arity: int) -> int:
    """hash_multiple(arity zeros), cached per arity (merkle_tree.cpp:347-357)."""
    return oracle.empty_hash(arity)


@functools.lru_cache(maxsize=None)
def _empty_hash_digits(arity: int) -> tuple:
    return tuple(int(v) for v in fr.int_to_digits(empty_hash_int(arity)))


def padded_leaf_count(n: int, arity: int) -> int:
    """Next power of arity >= n, minimum 1 (merkle_tree.cpp:49-53)."""
    return oracle.padded_leaf_count(n, arity)


def tree_height(leaf_count: int, arity: int) -> int:
    """Levels incl. leaves; exact integer arithmetic (vs the reference's FP
    logs, merkle_tree.cpp:359-367 — SURVEY.md Appendix B.9)."""
    return oracle.tree_height(leaf_count, arity)


def calculate_max_leaves(height: int, arity: int) -> int:
    """Max leaf capacity of a tree of ``height`` levels: ``arity**(height-1)``
    (merkle_tree.cpp:369-372, exact integers instead of std::pow)."""
    errors.validate_range(arity, MIN_ARITY, MAX_ARITY, "arity")
    if height < 1:
        raise errors.ValidationError(f"height must be >= 1, got {height}")
    return arity ** (height - 1)


def _build_levels(padded_leaves: jnp.ndarray, arity: int):
    """All tree levels from ``[m, 16]`` padded leaves (m a power of arity).

    Shapes are static per level, so the loop traces cleanly; each level is
    one batched ``hash_multiple`` over ``[g, arity, 16]`` groups (no
    transfers — contrast the reference's per-level malloc/H2D/D2H
    round-trip, merkle_tree_cuda.cu:159-259).  Group counts are padded to
    powers of two so every level of every tree size reuses one of a
    log-bounded set of compiled kernel executables (power-of-two arities
    pad by zero rows).
    """
    levels = [padded_leaves]
    level = padded_leaves
    while level.shape[0] > 1:
        g = level.shape[0] // arity
        gp = 1 << (g - 1).bit_length()
        work = level
        if gp > g:
            work = jnp.concatenate(
                [level, jnp.zeros(((gp - g) * arity, fr.NDIGITS), jnp.uint32)],
                axis=0,
            )
        hashed = _engine_hash_multiple(work.reshape(gp, arity, fr.NDIGITS))
        level = hashed[:g]
        levels.append(level)
    return tuple(levels)


@functools.partial(jax.jit, static_argnums=(1,))
def _build_levels_fused(padded_leaves: jnp.ndarray, arity: int):
    """GPU build path: the WHOLE level loop under one jit — the build is
    ONE device dispatch (plus one eager pad when the leaf count is not a
    power of arity), with no host round-trip between levels.

    Takes PRE-PADDED leaves so executables are keyed on (power-of-arity
    size, arity) — a log-bounded set — rather than one compile per raw
    leaf count.  Not used on the CPU (see :func:`_fuse_levels`)."""
    return _build_levels(padded_leaves, arity)


def build_tree_levels(leaves, arity: int = 2) -> List[jnp.ndarray]:
    """Build all levels bottom-up. ``leaves``: ``[n, 16] uint32`` (or anything
    ``jnp.asarray`` accepts). Returns [level0 .. root], level0 = padded
    leaves. Empty input returns [] (reference leaves root_ null,
    merkle_tree.cpp:29-42)."""
    MerkleConfig(arity)  # validate
    leaves = jnp.asarray(leaves, jnp.uint32)
    n = leaves.shape[0]
    if n == 0:
        return []
    padded = padded_leaf_count(n, arity)
    if padded > n:
        e = jnp.asarray(np.array(_empty_hash_digits(arity), np.uint32))
        pad = jnp.broadcast_to(e, (padded - n, fr.NDIGITS))
        leaves = jnp.concatenate([leaves, pad], axis=0)
    if _fuse_levels():
        return list(_build_levels_fused(leaves, arity))
    return list(_build_levels(leaves, arity))


def merkle_root(leaves, arity: int = 2) -> jnp.ndarray:
    """Root digits ``[16]``; empty input => empty_hash(arity)
    (merkle_tree.cpp:338-343)."""
    levels = build_tree_levels(leaves, arity)
    if not levels:
        return jnp.asarray(np.array(_empty_hash_digits(arity), np.uint32))
    return levels[-1][0]


# ---------------------------------------------------------------------------
# Proof generation — pure index arithmetic (merkle_tree_cuda.cu:261-292),
# vectorized over a batch of leaf indices.
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(0,))
def _gather_proofs(arity: int, leaf_indices: jnp.ndarray, *levels):
    """For each queried leaf: per level, its position in the arity-group and
    the arity-1 sibling hashes. Returns (positions [k, h], siblings
    [k, h, arity-1, 16])."""
    idx = leaf_indices.astype(jnp.int32)
    positions, siblings = [], []
    for level in levels[:-1]:  # root level contributes nothing
        pos = idx % arity
        group_start = (idx // arity) * arity
        child_ids = group_start[:, None] + jnp.arange(arity, dtype=jnp.int32)
        children = level[child_ids]  # [k, arity, 16]
        # sibling j skips the proved position: child index j + (j >= pos)
        j = jnp.arange(arity - 1, dtype=jnp.int32)
        sib_child = j[None, :] + (j[None, :] >= pos[:, None]).astype(jnp.int32)
        sibs = jnp.take_along_axis(children, sib_child[..., None], axis=1)
        positions.append(pos)
        siblings.append(sibs)
        idx = idx // arity
    return (
        jnp.stack(positions, axis=1),
        jnp.stack(siblings, axis=1),
    )


def generate_proofs(
    levels: Sequence[jnp.ndarray], arity: int, leaf_indices
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batch Merkle proofs, leaf->root order (merkle_tree.cpp:113-211).

    Returns (positions ``[k, h-1] int32``, siblings ``[k, h-1, a-1, 16]``).
    """
    if not levels:
        raise IndexError("empty tree")
    leaf_indices = jnp.atleast_1d(jnp.asarray(leaf_indices, jnp.int32))
    n = int(levels[0].shape[0])
    # Vectorized range check (one min/max over the whole batch — a Python
    # per-index loop costs seconds at 1M proofs); on failure re-raise via
    # validate_index with the first offending index, preserving the
    # reference's IndexError contract (error_handling.hpp:43-49).
    idx_np = np.asarray(leaf_indices)
    if idx_np.size:
        lo = int(idx_np.min())
        hi = int(idx_np.max())
        if lo < 0 or hi >= n:
            bad = idx_np[(idx_np < 0) | (idx_np >= n)]
            errors.validate_index(int(bad[0]), n, "leaf index")
    if len(levels) == 1:
        k = leaf_indices.shape[0]
        return (
            jnp.zeros((k, 0), jnp.int32),
            jnp.zeros((k, 0, arity - 1, fr.NDIGITS), jnp.uint32),
        )
    return _gather_proofs(arity, leaf_indices, *levels)


def generate_proof(levels, arity, leaf_index: int):
    """Single proof: (positions [h-1], siblings [h-1, a-1, 16])."""
    pos, sib = generate_proofs(levels, arity, [leaf_index])
    return pos[0], sib[0]


# ---------------------------------------------------------------------------
# Verification — vmapped root recomputation (the analog of
# batch_verify_proofs_kernel, merkle_tree_cuda.cu:67-118).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnums=(3,))
def _insert_at_position(current, pos, sibs, arity):
    """[k,16] current + [k] positions + [k,arity-1,16] siblings ->
    [k,arity,16] child groups (current node at its position, siblings
    around it — merkle_tree.cpp:224-253).  One small program reused across
    all levels of all verifications with the same (k, arity)."""
    slots = []
    for i in range(arity):
        below = sibs[:, min(i, arity - 2)]
        above = sibs[:, max(i - 1, 0)]
        cand = jnp.where((jnp.int32(i) > pos)[:, None], above, below)
        slots.append(jnp.where((jnp.int32(i) == pos)[:, None], current, cand))
    return jnp.stack(slots, axis=1)


def _verify_batch(arity, positions, siblings, leaves, root):
    """All k proofs verified together, level-by-level: each level builds the
    [k, arity, 16] child groups and runs ONE batched hash.  The whole-batch
    analog of batch_verify_proofs_kernel (merkle_tree_cuda.cu:67-118)
    without the CSR flattening; host-driven so the two small compiled
    programs (group-build, hash) are reused across every level."""
    current = leaves  # [k, 16]
    h = positions.shape[1]
    for lvl in range(h):
        group = _insert_at_position(
            current, positions[:, lvl], siblings[:, lvl], arity
        )
        current = _engine_hash_multiple(group)
    return jnp.all(current == root[None, :], axis=-1)


def verify_proofs(
    positions, siblings, leaves, root, arity: int
) -> jnp.ndarray:
    """Per-proof validity ``[k] bool``. ``positions [k,h]``, ``siblings
    [k,h,a-1,16]``, ``leaves [k,16]``, ``root [16]``.

    On the GPU all levels run in ONE jitted program (one kernel call per
    level); on the CPU the per-level batched path runs host-driven
    (bit-identical — differentially tested)."""
    positions = jnp.asarray(positions, jnp.int32)
    siblings = jnp.asarray(siblings, jnp.uint32)
    leaves = jnp.asarray(leaves, jnp.uint32)
    root = jnp.asarray(root, jnp.uint32)
    if _fuse_levels() and positions.shape[1] > 0:
        from cuzk_tpu.ops import verify_proofs_pallas

        return verify_proofs_pallas(positions, siblings, leaves, root, arity)
    return _verify_batch(arity, positions, siblings, leaves, root)


def verify_proof(positions, siblings, leaf, root, arity: int) -> bool:
    """Single-proof verification (merkle_tree.cpp:214-254)."""
    ok = verify_proofs(
        positions[None], siblings[None], jnp.asarray(leaf)[None], root, arity
    )
    return bool(ok[0])


# ---------------------------------------------------------------------------
# Deduplicated all-or-nothing batch verification.
#
# Proofs of one tree share all upper-level nodes: once two recomputation
# chains meet at a common node, every remaining level hashes identical
# (entering value, siblings, positions) inputs.  Which chains CAN meet is
# host-visible before any hashing: two proofs converge at level L exactly
# when their proof suffixes from L upward — positions[:, L:] and
# siblings[:, L:] — are byte-identical (the suffix fixes every rebuilt
# group above L up to the entering value).  The host builds that merge
# forest with numpy, and the device hashes each unique suffix node ONCE,
# checking at every merge point that the entering values agree.  When all
# merge checks pass, the shared chain IS each merged proof's recomputation,
# so the result equals the reference's per-proof semantics
# (merkle_tree_cuda.cu:67-118) bit-exactly; on any failed check the caller
# falls back to the full per-proof path (a mismatch almost always means an
# invalid batch, but only full recomputation decides exactly — hash
# collisions are never assumed impossible).
#
# At the reference's benchmark config (5K proofs of a 50K-leaf tree) this
# hashes ~6.7K unique groups instead of 40K: the upper levels are verified
# once instead of 5000 times.  The schedule is also smaller than the raw
# proofs, so the host->device upload shrinks too.
# ---------------------------------------------------------------------------

# Fixed odd 64-bit column constants for _row_hash_u64 (deterministic; 64
# columns cover any row width the proof shapes produce).  The hash is ONLY
# a bucketing accelerator: every hash-group is byte-confirmed against its
# representative before it is trusted (see _dedup_schedule), so a crafted
# or accidental collision can never merge distinct rows — it is detected
# on the host and the caller falls back to the exact per-proof path.
_COLUMN_SALTS = (
    np.random.default_rng(0xC0FFEE).integers(
        0, 1 << 63, 64, dtype=np.uint64
    )
    | np.uint64(1)
)


def _row_hash_u64(mat: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit polynomial hash of the byte rows of ``mat``.

    Used to BUCKET sibling rows instead of sorting 200-byte records; the
    buckets are then byte-confirmed exactly in _dedup_schedule (any
    mismatch aborts dedup entirely), so collisions cost performance only,
    never correctness, and the schedule build drops from ~13 ms to ~2 ms
    at the reference's 5K-proof config."""
    mat = np.ascontiguousarray(mat)
    k, w = mat.shape
    if w % 8:
        mat = np.concatenate([mat, np.zeros((k, 8 - w % 8), np.uint8)], axis=1)
    u = mat.view("<u8")
    # One-pass multiply-sum against fixed odd column constants (a LINEAR
    # hash: two row differences can be crafted to cancel — which is why
    # _dedup_schedule never trusts hash equality alone and byte-confirms
    # every bucket before using it).  einsum fuses the multiply and the
    # row reduction in one pass with no [k, w/8] temporary — measured
    # 7.6x over `(u * salts).sum(axis=1)` on the 1-core bench host, where
    # this is the largest term of the 5K-proof schedule build.
    return _hash_u64_rows(u)


def _unique_keys(keys: np.ndarray):
    """(first-occurrence indices, inverse map) over a ``[k] uint64`` key
    vector."""
    _, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    return first.astype(np.int32), inv.reshape(-1).astype(np.int32)


_native_sched = None


def _native_scheduler():
    """The native exact-grouping module (cuzk_tpu.native, scheduler.cpp),
    or ``False`` when it cannot build/load.  Native grouping keys its
    hash table by the FULL row bytes (probes byte-compare, never trust a
    hash), so it is exact by construction: no confirmation pass and no
    collision-decline path, at C speed — the numpy bucket-and-confirm
    path below stays as the portable fallback and differential check."""
    global _native_sched
    if _native_sched is None:
        try:
            from cuzk_tpu import native

            _native_sched = native if native.scheduler_available() else False
        except Exception:
            _native_sched = False
    return _native_sched


def _hash_u64_rows(u: np.ndarray) -> np.ndarray:
    """Bucketing hash over the trailing axis of an (arbitrarily strided)
    ``[..., w] uint64`` array — the same multiply-sum + avalanche as
    :func:`_row_hash_u64`, minus the byte-view plumbing.  Taking the u64
    view directly lets multi-level callers hash ``sib_u64[:, 1:]`` in
    place instead of materializing an 80 MB contiguous byte copy first
    (the largest single term of the 50K-proof schedule build)."""
    h = np.einsum("...j,j->...", u, _COLUMN_SALTS[: u.shape[-1]])
    h ^= h >> np.uint64(33)
    h = h * np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    return h


def _confirm_buckets(rows_u64: np.ndarray, first: np.ndarray, inv: np.ndarray) -> bool:
    """Byte-confirm a hash-bucketed grouping: every row must equal its
    bucket representative.  Rows that ARE their own representative are
    equal by identity, so only the duplicate members are gathered and
    compared — on mostly-unique levels (every proof its own group, the
    common case for large distinct-leaf batches) this does no row
    gathering at all.  Exactness is unchanged: the skipped comparisons
    are ``row == row``."""
    k = rows_u64.shape[0]
    if len(first) == k:
        return True  # every bucket a singleton: each row is its own rep
    rep = first[inv]
    dup = np.flatnonzero(rep != np.arange(k, dtype=rep.dtype))
    if not len(dup):
        return True
    return np.array_equal(rows_u64[dup], rows_u64[rep[dup]])


def _job_bucket(u: int) -> int:
    """Job counts pad so executables are reused across proof batches (same
    discipline as the hash batch buckets): powers of two up to 1024 —
    matching the kernel's lane-tile granularity — then multiples of 1024
    (the kernel skips inactive tiles at runtime, so tighter buckets cut
    real hash work; power-of-two padding above 1K wasted up to 60%)."""
    if u >= 1024:
        return ((u + 1023) // 1024) * 1024
    return max(8, 1 << (u - 1).bit_length())


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to ``n`` by replicating row 0 (padded jobs recompute job
    0's work, so every downstream equality check on them is vacuously
    true)."""
    if a.shape[0] == n:
        return a
    reps = np.broadcast_to(a[:1], (n - a.shape[0],) + a.shape[1:])
    return np.concatenate([a, reps], axis=0)


def _dedup_schedule(
    positions: np.ndarray, siblings: np.ndarray, leaves: np.ndarray
):
    """Host-side merge schedule (pure numpy — needs no hash values).

    Level 0 is CONTENT-keyed: each job is a unique reconstructed leaf
    group ``insert(leaf, pos, row)`` (computable on the host because leaf
    values are given).  This merges the up-to-``arity`` proofs of one
    group into ONE hash job — a suffix key cannot (each member has a
    different ``(pos, row)``), and for dense batches level 0 is most of
    the work (5K-proof reference config: 5000 suffix jobs -> 1250 content
    jobs).  Levels >= 1 stay SUFFIX-keyed (entering values are unknown on
    the host): two proofs share a level-L job only when
    (positions[:, L:], siblings[:, L:]) are byte-identical.

    Grouping is EXACT everywhere: the row hash only buckets; every bucket
    is confirmed byte-identical against its representative, and suffix
    identity propagates root-down with exact integer packings.  Any
    confirmation failure returns ``None`` and the caller must decide via
    the exact per-proof path: dedup can never silently merge proofs whose
    data differs.

    Returns ``(content, j0, upper, m1, iso)``:
      - ``content``: bucketed ``[n0b, arity, 16]`` unique level-0 groups;
      - ``j0[i]``: proof i's content-job id (< n0, unbucketed);
      - ``upper[L-1]`` for L = 1..h-1: ``(ent_idx, pos, sibs, checks)``
        bucketed job arrays; ``ent_idx`` indexes the previous level's
        outputs (level-0 job ids for L=1); ``checks`` (present for
        L >= 2, length n_{L-1} bucketed) holds for each level-L-1 job the
        L-1-job index whose output its parent actually used — suffix jobs
        have a unique parent, so one check per job covers every edge;
      - ``m1[i]``: proof i's level-1 job id (``None`` when h == 1).  A
        level-0 content job can feed MANY level-1 parents (members'
        upper paths may differ), so level 0's edges are checked
        per-proof on device: ``out0[j0[i]] == out0[ent_idx1[m1[i]]]``;
      - ``iso = (keys, counts, parents)``: the proof->job chain map used
        for per-proof failure isolation (:func:`_suspect_mask`) —
        ``keys[L][i]`` is proof i's level-L job id, ``counts[L]`` the
        actual (unbucketed) job count, ``parents[L][j]`` level-L job j's
        level-L+1 job (present for L = 1..h-2, the job levels whose
        merge checks ride the wire).
    """
    k, h = positions.shape
    arity = siblings.shape[2] + 1
    sib_flat = np.ascontiguousarray(siblings).reshape(k, h, -1)
    # u64 view of the same bytes: row confirmations gather/compare 8x
    # fewer elements (row width (a-1)*64 bytes is always a multiple of 8).
    sib_u64 = sib_flat.view(np.uint8).reshape(k, h, -1).view("<u8")

    # ---- Level 0: unique reconstructed groups (content-keyed) ----------
    pos0 = positions[:, 0]
    content = np.empty((k, arity, fr.NDIGITS), np.uint32)
    j = np.arange(arity - 1)
    col = j[None, :] + (j[None, :] >= pos0[:, None])  # sibling j's column
    content[np.arange(k)[:, None], col] = siblings[:, 0]
    content[np.arange(k), pos0] = leaves[:k]
    nat = _native_scheduler()
    if nat:
        cfirst, j0 = nat.group_rows(content.reshape(k, -1))
    else:
        c_u8 = content.reshape(k, -1).view(np.uint8)
        cfirst, j0 = _unique_keys(_row_hash_u64(c_u8))
        if not _confirm_buckets(c_u8.view("<u8"), cfirst, j0):
            return None  # host-hash collision: only the exact path decides
    content_b = _pad_rows(content[cfirst], _job_bucket(len(cfirst)))

    if h == 1:
        return content_b, j0, [], None, ([j0], (len(cfirst),), {})

    # ---- Levels >= 1: suffix group ids, root-down ----------------------
    # Per-level sibling-row hashes in one strided pass ([k, h-1] uint64);
    # only the numpy fallback needs them (native hashes rows in C).
    sib_keys = None if nat else _hash_u64_rows(sib_u64[:, 1:])
    gid = np.zeros(k, np.int64)
    ident = np.arange(k, dtype=np.int32)
    saturated = False  # every proof already its own suffix group?
    reps: List[np.ndarray] = [None] * h
    keys: List[np.ndarray] = [None] * h
    for L in range(h - 1, 0, -1):
        if saturated:
            # suffix_{L+1} already separates all k proofs, and suffix_L
            # refines suffix_{L+1} — every class stays a singleton.  Any
            # consistent numbering works downstream (jobs are addressed
            # through reps/keys only), so use the identity instead of
            # re-sorting k packed keys per remaining level.
            reps[L], keys[L] = ident, ident
            continue
        if nat:
            # Exact row ids and exact suffix triples from the native
            # hash-map grouper (no width limits, no confirmation pass).
            _rf, rid = nat.group_rows(sib_u64[:, L])
            reps[L], keys[L] = nat.group_triples(gid, rid, positions[:, L])
            gid = keys[L].astype(np.int64)
            saturated = len(reps[L]) == k
            continue
        # Row-equality ids: bucket by hash, then CONFIRM byte equality
        # against each bucket's representative — after confirmation, rid
        # equality <=> row equality exactly.
        rfirst, rid = _unique_keys(sib_keys[:, L - 1])
        if not _confirm_buckets(sib_u64[:, L], rfirst, rid):
            return None
        # suffix_L = (suffix_{L+1}, row_L, pos_L) — exact u64 packings of
        # inverse indices (gid/rid < k) and pos (< arity <= 8, gated to 8
        # bits by the caller).  One unique over the packed triple when it
        # fits u64 (k < 2^28 — injective 28+28+8 layout); the two-step
        # packing only for absurdly large batches.  Either way the
        # equivalence classes — and therefore first-occurrence reps and
        # inverse keys — are identical.
        if k < (1 << 28):
            reps[L], keys[L] = _unique_keys(
                (gid.astype(np.uint64) << np.uint64(36))
                | (rid.astype(np.uint64) << np.uint64(8))
                | positions[:, L].astype(np.uint64)
            )
        else:
            _, c1 = _unique_keys(
                (gid.astype(np.uint64) << np.uint64(32))
                | rid.astype(np.uint64)
            )
            reps[L], keys[L] = _unique_keys(
                (c1.astype(np.uint64) << np.uint64(8))
                | positions[:, L].astype(np.uint64)
            )
        gid = keys[L].astype(np.int64)
        saturated = len(reps[L]) == k

    keys[0] = j0  # level-0 job id per proof (content-keyed)
    upper = []
    parents = {}
    for L in range(1, h):
        r = reps[L]
        ub = _job_bucket(len(r))
        # Entering value = output of the rep proof's level-L-1 job.
        ent_idx = _pad_rows(keys[L - 1][r].reshape(-1, 1), ub).ravel()
        pos = _pad_rows(positions[r, L], ub)
        sibs = _pad_rows(siblings[r, L], ub)
        # Merge check over the previous level's outputs (levels >= 1 only:
        # a suffix job's defining suffix fixes its whole upper path, so it
        # has exactly ONE parent and one check per job covers every edge;
        # level-0 content jobs can have many parents — checked per-proof
        # by the caller via m1).  Padded jobs are copies of job 0, so
        # src 0 keeps their checks true.
        checks = np.zeros(0, np.int32)
        if L > 1:
            parent = keys[L][reps[L - 1]]  # level-L job of each L-1 job
            parents[L - 1] = parent
            checks = _pad_rows(
                ent_idx[parent].reshape(-1, 1), _job_bucket(len(parent))
            ).ravel()
        upper.append((ent_idx, pos, sibs, checks))

    counts = (len(cfirst),) + tuple(len(reps[L]) for L in range(1, h))
    return content_b, j0, upper, keys[1], (list(keys), counts, parents)


# Packed 16-bit wire format, shared with the hash path (fr.pack16 docs
# the soundness contract: digits MUST be range-checked < 2^16 first).
_pack16_host = fr.pack16
_unpack16 = fr.unpack16


def _dedup_verify_levels(arity, sizes, kb, tb, lm16, packed):
    """Device program: one hash per unique tree node touched, level by
    level, with merge-consistency checks both accumulated into scalar
    flags (the all-or-nothing fast path) and returned as per-proof /
    per-job masks (failure isolation: the host maps a failed check back
    to the proofs whose chains touch it and re-verifies only those).

    The whole schedule arrives as ONE flat uint32 vector ``packed`` —
    ``[value table (tb x 8) | root (8) | idx section | cidx
    (n0 x arity) | sidx (sum n_L x (arity-1), L >= 1)]``.  Every 256-bit
    value the verification touches — claimed leaves, level-0 group
    members, upper sibling nodes — lives ONCE in the byte-deduped value
    table (16-bit digits packed two per word, host range-gated); all
    other sections are u32 table/job indices.  Sharing one table across
    roles is what shrinks the wire: the reference's own 5K-proof
    benchmark re-proves 1024 leaves ~5x each, so its claimed-leaf rows,
    content groups and sibling rows are mostly the SAME values (164 KB
    of per-section data dedupes to ~100 KB), and because the host
    byte-confirms the table, value equality IS index equality — the
    leaf-binding check becomes an integer compare.

    The idx section is ``[jp (kb: j0 << 3 | pos0 — pos0 < arity <= 8
    needs 3 bits, j0 < k < 2^28 by the schedule's own packing bound) |
    lm (h == 1: lidx; h > 1 packed lm16: lidx << 16 | m1, one word;
    else lidx then m1, kb each) | per level L >= 1: ent_idx(n_L)
    pos(n_L) | per level L >= 2: checks(n_{L-1})]``, sliced by the
    static ``sizes`` (n0 = content jobs, then suffix-job counts).  One
    upload + one fused dispatch + one tiny readback, so byte count and
    dispatch count are minimized.

    Checks:
      - leaf binding: every proof's claimed-leaf table index equals the
        index at its position inside its content job (cidx[j0[i],
        pos0[i]] == lidx[i]; the host computed the two sides by
        independent paths — group scatter vs direct leaf lookup — so
        this genuinely re-checks the host's merge);
      - level-0 edges (h > 1): out0[j0[i]] == out0[ent_idx1[m1[i]]] —
        a content job can feed many level-1 parents, so edges are
        per-proof;
      - levels >= 1: each level-L job's output equals the entering value
        its (unique) parent used;
      - root: every last-level output equals the root.
    Returns ``(flags, bad)``: ``flags = [checks_ok, roots_ok] bool``;
    ``bad = [per-proof bad (kb) | per-job check fails (sizes[1..h-2]) |
    per-job root fails (sizes[h-1])] bool`` (read back only on
    failure)."""
    nd = fr.NDIGITS
    hw = nd // 2  # packed words per element
    h = len(sizes)
    n0 = sizes[0]
    upper_sizes = sizes[1:]
    total_upper = sum(upper_sizes)
    per_proof = 2 if (h == 1 or lm16) else 3
    idx_len = (
        per_proof * kb
        + sum(2 * n for n in upper_sizes)
        + sum(sizes[L - 1] for L in range(2, h))
    )
    o = tb * hw
    table = _unpack16(packed[:o].reshape(tb, hw))  # [tb, 16]
    root = _unpack16(packed[o : o + hw])
    o += hw
    idx_all = packed[o : o + idx_len].astype(jnp.int32)
    o += idx_len
    cidx = packed[o : o + n0 * arity].astype(jnp.int32).reshape(n0, arity)
    o += n0 * arity
    sidx = (
        packed[o : o + total_upper * (arity - 1)]
        .astype(jnp.int32)
        .reshape(total_upper, arity - 1)
        if total_upper
        else None
    )

    jp = idx_all[:kb]
    j0 = jp >> 3
    pos0 = jp & 7
    io = kb
    m1 = None
    if h == 1:
        lidx = idx_all[io : io + kb]
        io += kb
    elif lm16:
        w = idx_all[io : io + kb]
        lidx = w >> 16
        m1 = w & 0xFFFF
        io += kb
    else:
        lidx = idx_all[io : io + kb]
        m1 = idx_all[io + kb : io + 2 * kb]
        io += 2 * kb
    ents, poss = [], []
    for n in upper_sizes:
        ents.append(idx_all[io : io + n])
        poss.append(idx_all[io + n : io + 2 * n])
        io += 2 * n
    checks = {}
    for L in range(2, h):
        c = sizes[L - 1]
        checks[L] = idx_all[io : io + c]
        io += c

    # Level 0: hash the unique content groups; bind each proof's claimed
    # leaf to its slot inside its content job (indices into the confirmed
    # table, so an integer compare is exact value equality).
    content = table[cidx]  # [n0, arity, 16]
    out = _engine_hash_multiple(content)  # [n0, 16]
    proof_bad = cidx[j0, pos0] != lidx  # [kb]
    if h > 1:
        # Per-proof level-0 edge check (see docstring).
        proof_bad = jnp.logical_or(
            proof_bad, jnp.any(out[j0] != out[ents[0][m1]], axis=-1)
        )
    ok = jnp.logical_not(jnp.any(proof_bad))
    check_bads = []
    so = 0
    for i, n in enumerate(upper_sizes):
        L = i + 1
        ent = out[ents[i]]
        sibs = table[sidx[so : so + n]]  # [n, arity-1, 16]
        so += n
        group = _insert_at_position(ent, poss[i], sibs, arity)
        new_out = _engine_hash_multiple(group)
        if L + 1 < h:
            cb = jnp.any(new_out != new_out[checks[L + 1]], axis=-1)
            check_bads.append(cb)
            ok = jnp.logical_and(ok, jnp.logical_not(jnp.any(cb)))
        out = new_out
    root_bad = jnp.any(out != root[None, :], axis=-1)
    roots_ok = jnp.logical_not(jnp.any(root_bad))
    flags = jnp.stack([ok, roots_ok])
    bad = jnp.concatenate([proof_bad, *check_bads, root_bad])
    return flags, bad


_dedup_verify_fused = jax.jit(
    _dedup_verify_levels, static_argnums=(0, 1, 2, 3, 4)
)


class _Wire(NamedTuple):
    """A packed dedup-verify schedule ready for upload.  ``sizes``/``kb``/
    ``tb``/``lm16`` are the device program's static arguments (bucketed
    job counts, proof bucket, value-table bucket, lidx|m1 word-packing
    flag); ``packed`` is the single host uint32 upload buffer (layout on
    :func:`_dedup_verify_levels`); ``iso`` is the host-only proof->job
    chain map for failure isolation (:func:`_suspect_mask`)."""

    sizes: tuple
    kb: int
    tb: int
    lm16: bool
    packed: np.ndarray
    iso: tuple


def _table_bucket(u: int) -> int:
    """Value-table lengths pad so executables are reused across batches:
    powers of two up to 1024, then multiples of 256 (table rows are only
    gathered — no hash-tile granularity constraint — so the padding costs
    upload bytes only and 256 keeps it under ~12%)."""
    if u >= 1024:
        return ((u + 255) // 256) * 256
    return max(64, 1 << (u - 1).bit_length())


def _dedup_pack(positions, siblings, leaves_np, root_np, arity):
    """Host phase of the deduped verify: range gates, schedule build,
    value-table dedup, and single-buffer packing.  Returns a
    :class:`_Wire`, or ``None`` when the dedup path cannot soundly decide
    and the exact per-proof path must.  Split out so the benchmark can
    time host-schedule / upload / device-dispatch phases separately
    (``bench_batch_verify_resident``)."""
    k = positions.shape[0]
    # Range gates — cheap host checks BEFORE the schedule build, because a
    # tripped gate discards everything built after it:
    #  - positions must lie in [0, arity): the suffix-key packing uses 8
    #    bits per position, and the level-0 content scatter indexes by
    #    pos, so an attacker-controlled pos >= arity or < 0 could alias
    #    two distinct suffixes/groups without its data ever being hashed;
    #  - digits must be canonical 16-bit: the packed upload stores two
    #    digits per word, so d and d + 2^16 would alias;
    #  - arity must be within the reference's MAX_ARITY=8 domain
    #    (merkle_tree.hpp:20): the jp word packs pos0 in 3 bits, so a
    #    direct verify_all call with arity > 8 would silently mis-decode
    #    j0/pos0 instead of declining.
    # Either way the exact per-proof path decides (it inserts nothing at
    # an out-of-range position and hashes full-width digits, rejecting
    # such proofs), preserving bit-exact reference semantics.
    if (
        arity > MAX_ARITY
        or positions.min(initial=0) < 0
        or positions.max(initial=0) >= arity
        or leaves_np.max(initial=0) >> 16
        or root_np.max(initial=0) >> 16
        or siblings.max(initial=0) >> 16
    ):
        return None
    sched = _dedup_schedule(positions, siblings, leaves_np)
    if sched is None:  # host-hash bucket failed byte confirmation
        return None
    content, j0, upper, m1, iso = sched
    if k >= (1 << 28):  # jp = j0 << 3 | pos0 needs j0 < 2^28 (j0 < k)
        return None  # exact per-proof path decides (unreachable in practice)
    kb = _job_bucket(k)
    sizes = (content.shape[0],) + tuple(lvl[1].shape[0] for lvl in upper)
    n0b = content.shape[0]

    # Value table: byte-dedup EVERY 256-bit value on the wire — content
    # group members, upper sibling nodes, and the claimed leaves — into
    # one table, and ship u32 table indices in their place (same
    # hash-bucket-then-confirm discipline as the schedule itself, so a
    # crafted collision degrades to declining, never to unsoundness).
    # The claimed leaves ride V too even though each one is already a
    # content member: their indices (lidx) come from a direct lookup
    # while cidx comes from the group scatter, so the device's binding
    # compare re-checks the host's merge through independent paths.
    leaves_k = np.ascontiguousarray(leaves_np[:k])
    V = np.concatenate(
        [content.reshape(-1, fr.NDIGITS)]
        + [lvl[2].reshape(-1, fr.NDIGITS) for lvl in upper]
        + [leaves_k],
        axis=0,
    )
    nat = _native_scheduler()
    if nat:
        vfirst, vinv = nat.group_rows(V)
    else:
        vfirst, vinv = _unique_keys(_hash_u64_rows(V.view("<u8")))
        if not _confirm_buckets(V.view("<u8"), vfirst, vinv):
            return None  # host-hash collision: only the exact path decides
    tb = _table_bucket(len(vfirst))
    vinv = vinv.astype(np.uint32)
    e0 = n0b * arity
    eu = sum(lvl[2].shape[0] for lvl in upper) * (arity - 1)
    cidx = vinv[:e0]
    sidx = vinv[e0 : e0 + eu]
    lidx = vinv[e0 + eu :]

    # Pack the table, root, every index vector, and the group/sibling
    # table references into ONE uint32 upload (layout documented on
    # _dedup_verify_levels), digit data two-digits-per-word.  j0 and pos0
    # ride one word (j0 << 3 | pos0): pos0 < arity <= 8 and j0 < k < 2^28
    # (the schedule's own suffix-packing bound); lidx and m1 share one
    # word whenever both fit 16 bits (any table/job count < 65536 — all
    # but enormous batches).
    jp = (j0.astype(np.uint32) << np.uint32(3)) | positions[:, 0].astype(
        np.uint32
    )
    parts = [
        _pack16_host(_pad_rows(V[vfirst], tb)).ravel(),
        _pack16_host(root_np).ravel(),
        _pad_rows(jp.reshape(-1, 1), kb).ravel(),
    ]
    lm16 = False
    lidx_b = _pad_rows(lidx.reshape(-1, 1), kb).ravel()
    if m1 is None:
        parts.append(lidx_b)
    else:
        m1_b = _pad_rows(m1.reshape(-1, 1), kb).ravel().astype(np.uint32)
        # lidx < 2^15 (not 2^16): the device decodes the idx section as
        # int32, so the packed word must stay below 2^31 or the >> 16
        # would arithmetic-shift a sign bit into the index.
        lm16 = len(vfirst) < (1 << 15) and int(m1_b.max(initial=0)) < (1 << 16)
        if lm16:
            parts.append((lidx_b << np.uint32(16)) | m1_b)
        else:
            parts.append(lidx_b)
            parts.append(m1_b)
    for ent_idx, pos, _sibs, _checks in upper:
        parts.append(ent_idx.astype(np.uint32))
        parts.append(pos.astype(np.uint32))
    for _ent, _pos, _sibs, checks in upper[1:]:
        parts.append(checks.astype(np.uint32))
    parts.append(cidx)
    parts.append(sidx)
    return _Wire(sizes, kb, tb, lm16, np.concatenate(parts), iso)


def _suspect_mask(bad: np.ndarray, wire: _Wire, k: int):
    """Map the device's failure masks back to proofs.  Returns
    ``(suspects, root_false)``, both ``[k] bool``:

    - ``suspects``: proofs whose chains touch a failed binding/edge/merge
      check — their provenance is disputed, so only exact re-verification
      decides them.  Per-proof fails mark the proof directly; a failed
      merge check at level-L job j means job j's output differs from the
      entering value its PARENT consumed — every proof routed through
      that parent (keys[L+1] == parents[L][j]) used an entering value of
      disputed provenance, and any proof routed through job j itself
      shares the same parent (suffix refinement), so marking by parent
      covers both;
    - ``root_false``: non-suspect proofs whose last-level job missed the
      root.  For a check-CLEAN chain the dedup recomputation IS the
      proof's own recomputation (the soundness argument), so a root
      mismatch is definitive — no re-verification needed (a wrong root
      over a 50K batch costs the dedup pass alone, not a full exact
      pass).
    Padded rows/jobs replicate index 0, so slicing to the actual counts
    first never drops a failure (a padded failure implies index 0's)."""
    sizes, kb = wire.sizes, wire.kb
    keys, counts, parents = wire.iso
    h = len(sizes)
    suspects = bad[:kb][:k].copy()
    off = kb
    for ell in range(1, h - 1):
        seg = bad[off : off + sizes[ell]][: counts[ell]]
        off += sizes[ell]
        bj = np.flatnonzero(seg)
        if len(bj):
            suspects |= np.isin(keys[ell + 1], parents[ell][bj])
    seg = bad[off : off + sizes[h - 1]][: counts[h - 1]]
    bj = np.flatnonzero(seg)
    root_false = np.zeros(k, bool)
    if len(bj):
        root_false = np.isin(keys[h - 1], bj) & ~suspects
    return suspects, root_false


def _dedup_results(positions, siblings, leaves_np, root_np, arity):
    """Deduped per-proof verify with failure isolation.  Returns a
    ``[k] bool`` array bit-equal to the exact per-proof path, or ``None``
    when the dedup path declines (range gates / byte-confirmation
    failure) and the caller must run the exact path on everything.

    The happy path costs one upload + one fused dispatch + one 2-flag
    readback.  On failure the per-proof/per-job masks are read back
    (one more hop, ~kb + sum(sizes) bools), mapped to the suspect proofs
    via the schedule's chain map, and ONLY the suspects re-verify
    exactly — one tampered proof in a 50K batch costs the dedup pass
    plus a tiny exact pass, not a full re-upload of all k proofs (the
    reference's kernel is per-proof, merkle_tree_cuda.cu:67-118, and
    never pays twice; this path now matches its failure economics).
    Non-suspect proofs are sound to report as valid: every check on
    their own chain passed, so the shared chain IS their recomputation."""
    wire = _dedup_pack(positions, siblings, leaves_np, root_np, arity)
    if wire is None:
        return None
    k = positions.shape[0]
    packed = jnp.asarray(wire.packed)
    run = _dedup_verify_fused if _fuse_levels() else _dedup_verify_levels
    flags_dev, bad_dev = run(
        arity, wire.sizes, wire.kb, wire.tb, wire.lm16, packed
    )
    flags = np.asarray(flags_dev)
    if bool(flags[0]) and bool(flags[1]):
        return np.ones(k, bool)
    suspects, root_false = _suspect_mask(np.asarray(bad_dev), wire, k)
    out = np.ones(k, bool)
    out[root_false] = False
    si = np.flatnonzero(suspects)
    if len(si):
        out[si] = np.asarray(
            verify_proofs(
                positions[si], siblings[si], leaves_np[si], root_np, arity
            )
        )
    elif not root_false.any():
        return None  # defensive: a tripped flag always marks something
    return out


def verify_each(
    positions, siblings, leaves, root, arity: int, dedupe: bool = None
) -> np.ndarray:
    """Per-proof batch verification — the reference kernel's result
    semantics (one bool per proof, merkle_tree_cuda.cu:67-118, before the
    host's all_of).  Batches large enough to share tree nodes verify via
    the deduplicated schedule with per-proof failure isolation; ``dedupe``
    forces the choice for tests/benchmarks."""
    positions_np = np.asarray(positions, np.int32)
    siblings_np = np.asarray(siblings, np.uint32)
    k, h = positions_np.shape[:2]
    if dedupe is None:
        dedupe = k >= 64 and h >= 2
    if dedupe and h >= 1 and k >= 2:
        res = _dedup_results(
            positions_np, siblings_np,
            np.asarray(leaves, np.uint32),
            np.asarray(root, np.uint32), arity,
        )
        if res is not None:
            return res
    return np.asarray(verify_proofs(positions, siblings, leaves, root, arity))


def verify_all(
    positions, siblings, leaves, root, arity: int, dedupe: bool = None
) -> bool:
    """All-or-nothing batch verification — the reference's return convention
    (merkle_tree_cuda.cu:464, all_of over the kernel's per-proof bools)."""
    return bool(verify_each(positions, siblings, leaves, root, arity, dedupe).all())


# ---------------------------------------------------------------------------
# Incremental leaf updates — beyond-parity: the reference's update_leaf is
# a full rebuild (merkle_tree.cpp:290-301); here only the affected
# leaf->root paths rehash (O(k * height) sponges instead of O(n)), bit-
# identical to a rebuild because every recomputed node hashes exactly the
# inputs the rebuild would.
# ---------------------------------------------------------------------------


def _update_paths(arity, idx, vals, levels):
    """Scatter ``vals`` at leaf rows ``idx`` and rehash each affected
    group per level.  Duplicate PARENT indices among the k paths simply
    recompute the same value (idempotent scatter); ``idx`` itself must be
    unique (enforced by the caller)."""
    levels = list(levels)
    idx = idx.astype(jnp.int32)
    levels[0] = levels[0].at[idx].set(vals)
    for L in range(len(levels) - 1):
        pidx = idx // arity
        rows = (pidx * arity)[:, None] + jnp.arange(arity, dtype=jnp.int32)
        groups = levels[L][rows]  # [k, arity, 16]
        parents = _engine_hash_multiple(groups)
        levels[L + 1] = levels[L + 1].at[pidx].set(parents)
        idx = pidx
    return tuple(levels)


@functools.partial(jax.jit, static_argnums=(0,))
def _update_paths_fused(arity, idx, vals, *levels):
    """GPU path: the whole update is ONE dispatch (executables keyed on
    (arity, k-bucket, level shapes) — reused across updates of any
    same-shaped tree)."""
    return _update_paths(arity, idx, vals, levels)


def update_tree_levels(levels, arity: int, indices, values):
    """Incrementally update built levels: new level list with ``values``
    at leaf ``indices`` and only the affected paths rehashed.  Raises
    ``ValidationError`` for duplicate indices or a ``values`` row count
    that does not match ``indices`` (a silent jnp broadcast would set
    every indexed leaf to one value)."""
    idx_np = np.atleast_1d(np.asarray(indices, np.int64))
    if len(np.unique(idx_np)) != len(idx_np):
        raise errors.ValidationError("update indices must be unique")
    # Range-check here, not only in NaryMerkleTree.update_leaves: JAX
    # silently drops out-of-bounds scatter indices and clamps gathers, so
    # without this a direct caller would get a silently partial update.
    if idx_np.size and not (
        0 <= int(idx_np.min()) and int(idx_np.max()) < int(levels[0].shape[0])
    ):
        bad = idx_np[(idx_np < 0) | (idx_np >= int(levels[0].shape[0]))]
        errors.validate_index(int(bad[0]), int(levels[0].shape[0]), "leaf index")
    vals_np = np.atleast_2d(np.asarray(values, np.uint32))
    k = idx_np.shape[0]
    if vals_np.shape != (k, fr.NDIGITS):
        raise errors.ValidationError(
            f"values must be [{k}, {fr.NDIGITS}], got {vals_np.shape}"
        )
    kb = _job_bucket(k)
    # Pad with copies of update 0 (idempotent: same scatter value).
    idx_np = _pad_rows(idx_np.reshape(-1, 1), kb).ravel()
    vals = jnp.asarray(_pad_rows(vals_np, kb))
    idx = jnp.asarray(idx_np, jnp.int32)
    if _fuse_levels():
        return list(_update_paths_fused(arity, idx, vals, *levels))
    return list(_update_paths(arity, idx, vals, levels))


# ---------------------------------------------------------------------------
# Object-style wrapper for API parity with NaryMerkleTree
# (merkle_tree.hpp:54-110).
# ---------------------------------------------------------------------------

class NaryMerkleTree:
    """Functional-core OO wrapper: holds the level arrays and config."""

    def __init__(self, leaves=None, config: MerkleConfig = MerkleConfig()):
        self.config = config
        self._levels: List[jnp.ndarray] = []
        self._num_leaves = 0
        if leaves is not None:
            self.build_tree(leaves)

    def build_tree(self, leaves) -> bool:
        leaves = jnp.asarray(leaves, jnp.uint32)
        self._num_leaves = int(leaves.shape[0])
        self._levels = build_tree_levels(leaves, self.config.arity)
        return bool(self._levels)

    @property
    def levels(self) -> List[jnp.ndarray]:
        return self._levels

    def get_root_hash(self) -> jnp.ndarray:
        if not self._levels:
            raise ValueError("tree is empty")
        return self._levels[-1][0]

    def root_int(self) -> int:
        return fr.array_to_ints(self.get_root_hash()[None, :])[0]

    def get_tree_height(self) -> int:
        return len(self._levels)

    def get_leaf_count(self) -> int:
        return self._num_leaves

    def generate_proof(self, leaf_index: int):
        return generate_proof(self._levels, self.config.arity, leaf_index)

    def generate_batch_proofs(self, leaf_indices):
        return generate_proofs(self._levels, self.config.arity, leaf_indices)

    def verify_proof(self, positions, siblings, leaf) -> bool:
        return verify_proof(
            positions, siblings, leaf, self.get_root_hash(), self.config.arity
        )

    def verify_batch_proofs(self, positions, siblings, leaves) -> bool:
        return verify_all(
            positions, siblings, leaves, self.get_root_hash(), self.config.arity
        )

    def update_leaf(self, index: int, value) -> bool:
        """Update one leaf.  Bit-identical to the reference's full rebuild
        (merkle_tree.cpp:290-301) but O(height) — see update_leaves."""
        return self.update_leaves([index], jnp.asarray(value, jnp.uint32)[None])

    def update_leaves(self, indices, values) -> bool:
        """Batched incremental update: only the affected leaf->root paths
        rehash (O(k * height) sponges vs the reference's O(n) rebuild),
        producing bit-identical levels.  Indices must be unique and in
        range and ``values`` one row per index; returns False (tree
        untouched) otherwise."""
        if not self._levels:
            return False
        idx = np.atleast_1d(np.asarray(indices, np.int64))
        if idx.size == 0 or idx.min() < 0 or idx.max() >= self._num_leaves:
            return False
        try:  # uniqueness/shape validation lives in update_tree_levels
            new_levels = update_tree_levels(
                self._levels, self.config.arity, idx, values
            )
        except errors.ValidationError:
            return False
        self._levels = new_levels
        return True

    def insert_leaf(self, value) -> bool:
        """Append a leaf (merkle_tree.cpp:290-295).  When the padded level
        still has a free slot, the append is an O(height) incremental
        path update of that slot (it held ``empty_hash(arity)``, exactly
        what a rebuild would replace) — bit-identical to the reference's
        full rebuild, which only happens when capacity grows."""
        new = jnp.asarray(value, jnp.uint32)[None, :]
        if self._levels and self._num_leaves < self._levels[0].shape[0]:
            self._levels = update_tree_levels(
                self._levels, self.config.arity, [self._num_leaves], new
            )
            self._num_leaves += 1
            return True
        if self._levels:
            leaves = jnp.concatenate(
                [self._levels[0][: self._num_leaves], new], axis=0
            )
        else:
            leaves = new
        return self.build_tree(leaves)


def optimal_arity(leaf_count: int) -> int:
    """Arity heuristic matching CudaMerkleUtils::get_optimal_config_for_gpu
    (merkle_tree_cuda.cu:589-601): 2 below 1K leaves, 4 mid, 8 above 100K."""
    if leaf_count < 1_000:
        return 2
    if leaf_count <= 100_000:
        return 4
    return 8


def generate_test_leaves(count: int, seed: int = 42) -> np.ndarray:
    """Deterministic mt19937_64 leaves as digit arrays
    (merkle_tree.cpp:443-457)."""
    return fr.ints_to_array(oracle.generate_test_leaves(count, seed))


# ---------------------------------------------------------------------------
# MerkleUtils parity (merkle_tree.hpp:113-136)
# ---------------------------------------------------------------------------

def validate_proof_structure(positions, siblings, arity: int) -> bool:
    """Structural proof check (MerkleUtils::validate_proof,
    merkle_tree.cpp:374-393): matching level counts, positions in range,
    arity-1 siblings per level."""
    positions = np.asarray(positions)
    siblings = np.asarray(siblings)
    if positions.ndim != 1 or siblings.ndim != 3:
        return False
    if positions.shape[0] != siblings.shape[0]:
        return False
    if siblings.shape[1] != arity - 1 or siblings.shape[2] != fr.NDIGITS:
        return False
    return bool(np.all((positions >= 0) & (positions < arity)))


def benchmark_tree(
    leaf_count: int, arity: int, num_proofs: int = 100, seed: int = 42
):
    """Build + proof-generation + verification timings in one
    :class:`~cuzk_tpu.utils.stats.TreeBenchmarkResult`
    (MerkleUtils::benchmark_tree, merkle_tree.cpp:399-440).

    The reference times ``num_proofs`` sequential ``generate_proof`` calls
    and ``num_proofs`` repeats of one ``verify_proof``; here both phases
    are the batched APIs (``generate_batch_proofs`` over ``num_proofs``
    random indices, ``verify_batch_proofs`` of those proofs) — the batched
    equivalents a caller would actually use.  Deterministic indices
    (seeded) instead of the reference's random_device, so results are
    reproducible.  One un-timed warm-up of each phase first, so compiles
    do not land in the reported numbers; each timed phase ends in
    ``jax.block_until_ready``."""
    import time as _time

    from cuzk_tpu.utils.stats import TreeBenchmarkResult

    leaves = jnp.asarray(generate_test_leaves(leaf_count, seed))
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, leaf_count, num_proofs)

    # Warm-up: compile every executable the timed phases will run.
    tree = NaryMerkleTree(leaves, MerkleConfig(arity))
    jax.block_until_ready(tree.levels[-1])
    wpos, wsib = tree.generate_batch_proofs(idx)
    jax.block_until_ready(wsib)
    verify_all(
        wpos, wsib, tree.levels[0][jnp.asarray(idx)],
        tree.get_root_hash(), arity,
    )

    start = _time.perf_counter()
    tree = NaryMerkleTree(leaves, MerkleConfig(arity))
    jax.block_until_ready(tree.levels[-1])
    build_ms = (_time.perf_counter() - start) * 1e3

    start = _time.perf_counter()
    pos, sib = tree.generate_batch_proofs(idx)
    jax.block_until_ready(sib)
    proof_ms = (_time.perf_counter() - start) * 1e3

    proved = tree.levels[0][jnp.asarray(idx)]
    root = tree.get_root_hash()
    start = _time.perf_counter()
    ok = verify_all(pos, sib, proved, root, arity)
    verify_ms = (_time.perf_counter() - start) * 1e3
    if not ok:
        raise errors.ComputationError("benchmark_tree: proofs failed to verify")

    return TreeBenchmarkResult(
        leaf_count=leaf_count,
        arity=arity,
        tree_height=tree.get_tree_height(),
        build_time_ms=round(build_ms, 3),
        proof_time_ms=round(proof_ms, 3),
        verify_time_ms=round(verify_ms, 3),
    )


def compare_trees(a: "NaryMerkleTree", b: "NaryMerkleTree") -> bool:
    """Root/height/leaf-count equality (MerkleUtils::compare_trees,
    merkle_tree.cpp:395-412)."""
    if not a.levels or not b.levels:
        return bool(a.levels) == bool(b.levels)
    return (
        a.get_tree_height() == b.get_tree_height()
        and a.get_leaf_count() == b.get_leaf_count()
        and bool(jnp.all(a.get_root_hash() == b.get_root_hash()))
    )


def print_tree(tree: "NaryMerkleTree", max_nodes_per_level: int = 8) -> str:
    """Level-by-level render (NaryMerkleTree::print_tree,
    merkle_tree.cpp:319-344).  Returns the string (and prints it)."""
    lines = []
    if not tree.levels:
        lines.append("(empty tree)")
    else:
        for lvl in range(len(tree.levels) - 1, -1, -1):
            vals = fr.array_to_ints(tree.levels[lvl][:max_nodes_per_level])
            shown = ", ".join(f"0x{v:016x}"[:18] for v in vals)
            extra = tree.levels[lvl].shape[0] - len(vals)
            suffix = f" ... (+{extra})" if extra > 0 else ""
            name = "root" if lvl == len(tree.levels) - 1 else f"level {lvl}"
            lines.append(f"{name}: [{shown}]{suffix}")
    out = "\n".join(lines)
    print(out)
    return out


@functools.partial(jax.jit, static_argnums=(1, 2))
def _build_batch_levels_fused(level: jnp.ndarray, arity: int, padded: int):
    """GPU path for equal-size batch builds: the whole side-by-side level
    loop under one jit — ONE device dispatch for all k trees (see
    :func:`_build_levels_fused` for the dispatch economics).  Executables
    are keyed per (k, padded, arity): batch-tree workloads typically reuse
    one k across calls, so bucketing k (padding with dummy trees) would
    trade real hash work for compile reuse — not worth it."""
    k = level.shape[0] // padded
    levels = [level]
    m = padded
    while m > 1:
        g = m // arity
        level = _engine_hash_multiple(level.reshape(k * g, arity, fr.NDIGITS))
        levels.append(level)
        m = g
    return tuple(levels)


def build_batch_trees(
    leaf_sets, arity: int = 2
) -> List["NaryMerkleTree"]:
    """Build many trees.  Equal-size sets are built as ONE fused batched
    program (levels carry a tree axis) — the reference loops sequentially
    (merkle_tree_cuda.cu:467-482); mixed sizes fall back to per-tree builds.
    """
    sizes = {int(np.asarray(ls).shape[0]) for ls in leaf_sets}
    if len(sizes) == 1 and sizes != {0}:
        n = sizes.pop()
        k = len(leaf_sets)
        stacked = jnp.stack([jnp.asarray(ls, jnp.uint32) for ls in leaf_sets])
        padded = padded_leaf_count(n, arity)
        if padded > n:
            e = jnp.asarray(np.array(_empty_hash_digits(arity), np.uint32))
            pad = jnp.broadcast_to(e, (k, padded - n, fr.NDIGITS))
            stacked = jnp.concatenate([stacked, pad], axis=1)
        # level loop over [k * m, 16] with trees side by side: group
        # boundaries never cross trees because m is a power of arity.
        level = stacked.reshape(k * padded, fr.NDIGITS)
        if _fuse_levels():
            levels = list(_build_batch_levels_fused(level, arity, padded))
        else:
            levels = [level]
            m = padded
            while m > 1:
                g = m // arity
                hashed = _engine_hash_multiple(
                    level.reshape(k * g, arity, fr.NDIGITS)
                )
                level = hashed
                levels.append(level)
                m = g
        trees = []
        for t in range(k):
            tree = NaryMerkleTree(config=MerkleConfig(arity))
            tree._num_leaves = n
            tree._levels = [
                lv.reshape(k, -1, fr.NDIGITS)[t] for lv in levels
            ]
            trees.append(tree)
        return trees
    return [
        NaryMerkleTree(ls, MerkleConfig(arity)) for ls in leaf_sets
    ]


# ---------------------------------------------------------------------------
# Checkpoint / resume (no reference analog — SURVEY.md §5 lists it as the
# one optional aux subsystem: persist tree levels so large builds are
# restartable / shippable between hosts).
# ---------------------------------------------------------------------------

def save_tree(tree: "NaryMerkleTree", path: str) -> None:
    """Serialize a built tree (config + every level) to an ``.npz`` file.

    Levels are written as host numpy arrays; loading restores device
    arrays lazily on first use.  The root is round-trip-verified by
    :func:`load_tree` against the stored arity's rebuild invariants only
    implicitly (levels are trusted data — verify against ``merkle_root``
    if the file crosses a trust boundary)."""
    errors.validate_non_empty(tree.levels, "tree levels")
    np.savez_compressed(
        path,
        arity=np.int64(tree.config.arity),
        num_leaves=np.int64(tree.get_leaf_count()),
        **{
            f"level_{i}": np.asarray(lv, np.uint32)
            for i, lv in enumerate(tree.levels)
        },
    )


def load_tree(path: str, verify: bool = False) -> "NaryMerkleTree":
    """Restore a tree saved by :func:`save_tree` without rehashing.

    ``verify=True`` rebuilds every level from the stored leaves and
    compares bit-for-bit — the check :func:`save_tree`'s docstring tells
    callers to do by hand for files crossing a trust boundary (cost: one
    full build).  A root-only check would miss a tampered intermediate
    level whose root happens to still chain correctly; comparing all
    levels does not.  Raises :class:`~cuzk_tpu.utils.errors.ComputationError`
    on any mismatch."""
    with np.load(path) as data:
        arity = int(data["arity"])
        num_leaves = int(data["num_leaves"])
        n_levels = sum(1 for k in data.files if k.startswith("level_"))
        levels = [
            jnp.asarray(data[f"level_{i}"], jnp.uint32)
            for i in range(n_levels)
        ]
    if verify:
        rebuilt = build_tree_levels(levels[0], arity)
        if len(rebuilt) != len(levels) or any(
            not np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(rebuilt, levels)
        ):
            raise errors.ComputationError(
                f"loaded tree failed verification: stored levels do not "
                f"match a rebuild from the stored leaves ({path})"
            )
    tree = NaryMerkleTree(config=MerkleConfig(arity))
    tree._num_leaves = num_leaves
    tree._levels = levels
    return tree
