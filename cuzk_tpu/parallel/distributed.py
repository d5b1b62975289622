"""Sharded hashing and Merkle builds over a device mesh.

The reference has no distributed dimension at all — its only parallelism is
one CUDA thread per element (SURVEY.md §2.2) and "batch trees" is a host
for-loop (merkle_tree_cuda.cu:467-482).  This module lifts that batching to
a mesh of devices:

- **Data-parallel hashing**: hash batches sharded over the mesh's ``data``
  axis via ``NamedSharding`` + jit — XLA runs each shard's fused permutation
  locally, no collectives.
- **Sharded tree build**: leaves live sharded; each device builds its
  contiguous subtree bottom-up while group boundaries stay local (local
  level size divisible by arity), then ONE ``lax.all_gather`` collapses the shrunken level onto every device and the few remaining upper
  levels are computed replicated (log_a(#devices) tiny levels).  Bit-exact
  vs the single-device build because shards hold contiguous leaf blocks and
  the gather preserves axis order.

The build is host-driven per level (like the single-device tree): each local
level is one small ``shard_map``'d batched-hash program and the gather is its
own tiny program, so compiled executables stay small and are reused across
levels, tree sizes, and runs (vs tracing the whole tree into one giant
program).  No transfers cross the host boundary until the root is fetched.

Multi-host entry: call ``jax.distributed.initialize()`` before building the
mesh; everything below is expressed against logical devices so the same
program runs on 1 device, 1 host, or N hosts.  A 1-D mesh suits GPUs of one
host joined all to all by NVLink: every pair of devices is equally close.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuzk_tpu import merkle
from cuzk_tpu.field import fr
from cuzk_tpu.ops import hash_pair_pallas, hash_single_pallas

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def shard_batch(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Place ``[n, ...]`` on the mesh sharded along axis 0.

    Host arrays go straight to ``device_put`` with the (possibly
    multi-process) sharding: when the mesh spans processes, each process
    transfers only its addressable shards, so this works unchanged under
    ``jax.distributed`` (every process holds the same host value)."""
    spec = P(axis_name, *([None] * (np.ndim(x) - 1)))
    if not isinstance(x, jax.Array):
        x = np.ascontiguousarray(np.asarray(x, np.uint32))
    elif x.dtype != jnp.uint32:
        # Normalize device arrays too: the shard_map'd hash kernels assume
        # uint32 digits, and device_put does not convert dtypes.
        x = x.astype(jnp.uint32)
    return jax.device_put(x, NamedSharding(mesh, spec))


def _mesh_key(mesh: Mesh):
    """Value-based cache identity for a mesh: device ids, the device-grid
    SHAPE (two meshes over the same devices reshaped differently partition
    differently), and axis names.  Keying on ``id(mesh)`` (round 2) was
    unsound — a new Mesh allocated at a garbage-collected Mesh's address
    would hit the stale executable for the WRONG mesh — and grew one
    entry per Mesh object; this key is stable across equal meshes and
    collision-free across different ones."""
    return (
        tuple(d.id for d in mesh.devices.flat),
        mesh.devices.shape,
        tuple(mesh.axis_names),
    )


def _shmap_hash(mesh: Mesh, axis_name: str, kind: str):
    """shard_map'd batched hashing: the body compiles once at the per-shard
    shape (no GSPMD partitioner pass — much cheaper to compile and exactly
    the data-parallel program we want: zero collectives)."""
    key = ("hash", _mesh_key(mesh), axis_name, kind)
    fn = _LEVEL_CACHE.get(key)
    if fn is None:
        # Per-shard bodies are the single-device ops: the CUDA kernel on a
        # GPU, the jnp path elsewhere.
        if kind == "pairs":
            body = hash_pair_pallas
            in_specs = (P(axis_name, None), P(axis_name, None))
        else:
            body = hash_single_pallas
            in_specs = (P(axis_name, None),)
        fn = jax.jit(
            jax.shard_map(
                body,
                mesh=mesh,
                in_specs=in_specs,
                out_specs=P(axis_name, None),
                check_vma=False,
            )
        )
        _LEVEL_CACHE[key] = fn
    return fn


def sharded_hash_pairs(left, right, mesh: Mesh, axis_name: str = DATA_AXIS):
    """Data-parallel batched pair hash: inputs sharded over the mesh, output
    sharded the same way. The mesh-level analog of the reference's
    thread-per-element batch kernel (poseidon_cuda.cu:166-182)."""
    return _shmap_hash(mesh, axis_name, "pairs")(
        shard_batch(left, mesh, axis_name), shard_batch(right, mesh, axis_name)
    )


def sharded_hash_single(x, mesh: Mesh, axis_name: str = DATA_AXIS):
    return _shmap_hash(mesh, axis_name, "single")(
        shard_batch(x, mesh, axis_name)
    )


# ---------------------------------------------------------------------------
# Sharded Merkle build — small per-level programs
# ---------------------------------------------------------------------------

_LEVEL_CACHE = {}


def _local_level_fn(mesh: Mesh, axis_name: str, arity: int):
    """shard_map'd one-level reduction: [m,16] sharded -> [m/arity,16]
    sharded.  Group boundaries stay shard-local (caller guarantees the
    per-shard size is divisible by arity)."""
    key = ("level", _mesh_key(mesh), axis_name, arity)
    fn = _LEVEL_CACHE.get(key)
    if fn is None:

        def per_shard(local_level):
            groups = local_level.reshape(
                local_level.shape[0] // arity, arity, fr.NDIGITS
            )
            # Engine dispatch (merkle._engine_hash_multiple): the CUDA
            # kernel per shard on a GPU, the jnp path elsewhere.
            return merkle._engine_hash_multiple(groups)

        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=mesh,
                in_specs=P(axis_name, None),
                out_specs=P(axis_name, None),
                check_vma=False,
            )
        )
        _LEVEL_CACHE[key] = fn
    return fn


def _gather_fn(mesh: Mesh, axis_name: str):
    """shard_map'd all-gather: [m,16] sharded -> [m,16] replicated."""
    key = ("gather", _mesh_key(mesh), axis_name)
    fn = _LEVEL_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            jax.shard_map(
                lambda x: jax.lax.all_gather(x, axis_name, tiled=True),
                mesh=mesh,
                in_specs=P(axis_name, None),
                out_specs=P(None, None),
                check_vma=False,
            )
        )
        _LEVEL_CACHE[key] = fn
    return fn


def sharded_build_levels(
    leaves, arity: int, mesh: Mesh, axis_name: str = DATA_AXIS
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Build a Merkle tree from mesh-sharded leaves.

    Returns ``(sharded_levels, replicated_levels)``: the lower levels live
    sharded along the mesh (level 0 = padded leaves), the gathered level and
    everything above it are replicated; ``replicated_levels[-1][0]`` is the
    root.  ``replicated_levels[0]`` is the gathered (global) version of
    ``sharded_levels[-1]``; concatenating ``sharded_levels[:-1] +
    replicated_levels`` therefore yields exactly
    ``merkle.build_tree_levels``.
    """
    merkle.MerkleConfig(arity)
    leaves = jnp.asarray(leaves, jnp.uint32)
    n = int(leaves.shape[0])
    if n == 0:
        raise ValueError("cannot shard-build an empty tree")
    d = mesh.shape[axis_name]
    m = merkle.padded_leaf_count(n, arity)
    if m % d != 0:
        # Degenerate (tiny tree on a big mesh): replicated fallback.
        levels = merkle.build_tree_levels(leaves, arity)
        return [], levels
    if m > n:
        e = np.array(merkle._empty_hash_digits(arity), np.uint32)
        pad = jnp.broadcast_to(jnp.asarray(e), (m - n, fr.NDIGITS))
        leaves = jnp.concatenate([leaves, pad], axis=0)
    leaves = shard_batch(leaves, mesh, axis_name)

    level_fn = _local_level_fn(mesh, axis_name, arity)
    local_m = m // d
    level = leaves
    sharded_levels = [level]
    while local_m > 1 and local_m % arity == 0:
        level = level_fn(level)
        local_m //= arity
        sharded_levels.append(level)

    gathered = _gather_fn(mesh, axis_name)(level)
    replicated_levels = [gathered]
    g = gathered
    while g.shape[0] > 1:
        # Replicated upper levels: plain batched hashing (tiny arrays),
        # reusing the single-device level executables.
        groups = g.reshape(g.shape[0] // arity, arity, fr.NDIGITS)
        g = merkle._engine_hash_multiple(groups)
        replicated_levels.append(g)
    return sharded_levels, replicated_levels


def sharded_merkle_root(
    leaves, arity: int, mesh: Mesh, axis_name: str = DATA_AXIS
) -> jnp.ndarray:
    """Root ``[16]`` of a sharded tree build."""
    _, replicated = sharded_build_levels(leaves, arity, mesh, axis_name)
    return replicated[-1][0]


# ---------------------------------------------------------------------------
# Sharded proof generation — per level, only the O(k * arity) nodes a proof
# batch actually touches cross the mesh (a masked psum), never the whole
# sharded level (merkle.generate_proofs would all-gather every lower level
# of a 1M-leaf tree).
# ---------------------------------------------------------------------------


def _group_extract_fn(mesh: Mesh, axis_name: str, arity: int):
    """shard_map'd sparse group fetch: (sharded level [m,16], replicated
    group starts [k]) -> replicated ``[k, arity, 16]`` child groups.

    Each shard contributes the groups whose rows it owns (group boundaries
    never straddle shards: shard sizes are multiples of ``arity``), zeros
    elsewhere; one ``psum`` of the k-sized result replicates it.  Per-level
    communication is O(k * arity) field elements, independent of level size.
    """
    key = ("pgather", _mesh_key(mesh), axis_name, arity)
    fn = _LEVEL_CACHE.get(key)
    if fn is None:

        def per_shard(level_local, group_start):
            local_m = level_local.shape[0]
            base = jax.lax.axis_index(axis_name).astype(jnp.int32) * local_m
            rel = group_start.astype(jnp.int32) - base
            owned = (rel >= 0) & (rel < local_m)
            rel_c = jnp.clip(rel, 0, max(local_m - arity, 0))
            rows = rel_c[:, None] + jnp.arange(arity, dtype=jnp.int32)
            children = level_local[rows]  # [k, arity, 16]
            children = jnp.where(owned[:, None, None], children, 0)
            return jax.lax.psum(children, axis_name)

        fn = jax.jit(
            jax.shard_map(
                per_shard,
                mesh=mesh,
                in_specs=(P(axis_name, None), P()),
                out_specs=P(),
                check_vma=False,
            )
        )
        _LEVEL_CACHE[key] = fn
    return fn


def sharded_generate_proofs(
    sharded_levels: List[jnp.ndarray],
    replicated_levels: List[jnp.ndarray],
    arity: int,
    leaf_indices,
    mesh: Mesh,
    axis_name: str = DATA_AXIS,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batch proofs from a sharded build (``sharded_build_levels`` output).

    Returns the same ``(positions [k, h-1], siblings [k, h-1, a-1, 16])``
    layout as :func:`merkle.generate_proofs` — bit-identical, verified by
    tests/test_distributed.py.  Lower (sharded) levels are fetched with the
    sparse group extractor above; replicated upper levels index locally.
    """
    idx = jnp.atleast_1d(jnp.asarray(leaf_indices, jnp.int32))
    positions, siblings = [], []
    extract = _group_extract_fn(mesh, axis_name, arity)

    def append_level(children, pos):
        j = jnp.arange(arity - 1, dtype=jnp.int32)
        sib_child = j[None, :] + (j[None, :] >= pos[:, None]).astype(jnp.int32)
        sibs = jnp.take_along_axis(children, sib_child[..., None], axis=1)
        positions.append(pos)
        siblings.append(sibs)

    # Sharded lower levels (all but the last, which is gathered as
    # replicated_levels[0] and handled below).
    for level in sharded_levels[:-1]:
        pos = idx % arity
        group_start = (idx // arity) * arity
        append_level(extract(level, group_start), pos)
        idx = idx // arity
    # Replicated upper levels (tiny): local gather, same math as the
    # single-device path (merkle._gather_proofs).
    for level in replicated_levels[:-1]:
        pos = idx % arity
        group_start = (idx // arity) * arity
        rows = group_start[:, None] + jnp.arange(arity, dtype=jnp.int32)
        append_level(level[rows], pos)
        idx = idx // arity
    if not positions:
        k = idx.shape[0]
        return (
            jnp.zeros((k, 0), jnp.int32),
            jnp.zeros((k, 0, arity - 1, fr.NDIGITS), jnp.uint32),
        )
    return jnp.stack(positions, axis=1), jnp.stack(siblings, axis=1)


# ---------------------------------------------------------------------------
# Multi-process entry (jax.distributed) — run the same SPMD program over an
# N-host slice.  The CPU-backend analog is tested by tests/test_multiprocess
# with two spawned localhost processes.
# ---------------------------------------------------------------------------


def initialize_multiprocess(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` wrapper: call once per process before
    any other JAX use, then build meshes with :func:`make_mesh` over the
    GLOBAL device list — every function in this module is expressed against
    logical mesh axes, so the same program runs on 1 device or N hosts
    (XLA picks the collective transport from the device topology, not this
    code).

    ``local_device_count`` forces the per-process CPU device count (test
    meshes); it must be set before the backend initializes.
    """
    import os

    import jax

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{local_device_count}"
        ).strip()
        jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
