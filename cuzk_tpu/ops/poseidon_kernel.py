"""The accelerated Poseidon ops: a CUDA kernel on the GPU, jnp elsewhere.

The twin of :mod:`cuzk_tpu.poseidon`, in the role the CUDA kernels play in
the reference (poseidon_cuda.cu:148-206): one thread per state, the
64-round permutation in registers, elements as four 64-bit limbs inside the
kernel (``native/poseidon_cuda.cu`` over ``native/poseidon_fr.h``), called
through ``jax.ffi``.  At the boundary elements stay the repo's ``[..., 16]``
uint32 digit format.

The public ``*_pallas`` names are the accelerated API the engines, the
Merkle layer and the parallel layer call.  :func:`~cuzk_tpu.utils.device.on_gpu`
decides, once per call, what they run: the kernel on a GPU, the plain jnp
reference path elsewhere.  On a GPU the kernel library is built (nvcc, at
first use) and loaded, or the call raises: nothing falls back to jnp there.

Batches are padded to a power-of-two bucket (at least one 128-thread
block) so each jitted chain compiles once per bucket; the true count rides
along as a device scalar and threads past it exit before any arithmetic.
The hash width and domain separator are the kernel's own arguments, so no
width padding is needed.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import jax
import jax.numpy as jnp

from cuzk_tpu import oracle
from cuzk_tpu.field import fr
from cuzk_tpu.utils.device import on_gpu

ND = fr.NDIGITS

# The 192 round constants as [192, 8] uint32: the little-endian bytes of
# four 64-bit limbs each, the kernel's limb layout.
RC_WORDS = np.array(
    [[(c >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for c in oracle.RC],
    dtype=np.uint32,
)

_SPONGE_TARGET = "cuzk_poseidon_sponge"
_PERMUTATION_TARGET = "cuzk_poseidon_permutation"
_registered = False
_register_lock = threading.Lock()


def _register_kernels() -> None:
    """Build (first use) and load the CUDA library, then register its FFI
    targets.  Raises on any failure."""
    global _registered
    with _register_lock:
        if _registered:
            return
        from cuzk_tpu import native

        lib = ctypes.cdll.LoadLibrary(native.ensure_cuda_built())
        jax.ffi.register_ffi_target(
            _SPONGE_TARGET, jax.ffi.pycapsule(lib.CuzkPoseidonSponge),
            platform="CUDA",
        )
        jax.ffi.register_ffi_target(
            _PERMUTATION_TARGET,
            jax.ffi.pycapsule(lib.CuzkPoseidonPermutation),
            platform="CUDA",
        )
        _registered = True


def _sponge_kernel(x: jnp.ndarray, active: jnp.ndarray, ds: int):
    """CUDA sponge: ``x [b, n, 16]`` -> ``[b, 16]``; rows >= ``active[0]``
    are left unwritten."""
    _register_kernels()
    return jax.ffi.ffi_call(
        _SPONGE_TARGET, jax.ShapeDtypeStruct((x.shape[0], ND), jnp.uint32)
    )(x, jnp.asarray(RC_WORDS), active, ds=np.int32(ds))


def _permutation_kernel(states: jnp.ndarray, active: jnp.ndarray):
    """CUDA raw permutation: ``[b, 3, 16]`` -> ``[b, 3, 16]``."""
    _register_kernels()
    return jax.ffi.ffi_call(
        _PERMUTATION_TARGET, jax.ShapeDtypeStruct(states.shape, jnp.uint32)
    )(states, jnp.asarray(RC_WORDS), active)


def poseidon_mod():
    """Lazy import of the jnp reference path (keeps the import graph
    acyclic: cuzk_tpu.poseidon never imports this module)."""
    from cuzk_tpu import poseidon

    return poseidon


def _bucket(b: int) -> int:
    """Padded batch for ``b`` elements: the next power of two, at least one
    128-thread block."""
    return 1 << max(7, (b - 1).bit_length())


# Device-resident active counts, cached so an eager call does not upload a
# fresh scalar each time.
_ACTIVE_CACHE = {}


def _active(b: int) -> jnp.ndarray:
    arr = _ACTIVE_CACHE.get(b)
    if arr is None:
        arr = jnp.full((1,), b, jnp.int32)
        # Under an enclosing jit trace (e.g. the fused tree build) this is a
        # staged constant: caching it would leak the tracer.
        if not isinstance(arr, jax.core.Tracer):
            _ACTIVE_CACHE[b] = arr
    return arr


def _pad_rows(x: jnp.ndarray, bp: int) -> jnp.ndarray:
    pad = bp - x.shape[0]
    if pad == 0:
        return x
    return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))


def _bucketed(call, *operands):
    """Pad every operand's batch axis to the bucket, run ``call(*padded,
    active)``, slice the result back to the true batch."""
    b = operands[0].shape[0]
    bp = _bucket(b)
    out = call(*(_pad_rows(x, bp) for x in operands), _active(b))
    return out if bp == b else out[:b]


@functools.partial(jax.jit, static_argnums=(2,))
def _sponge_chain(x, active, ds: int):
    return _sponge_kernel(x, active, ds)


@jax.jit
def _single_chain(x, active):
    return _sponge_kernel(x[:, None, :], active, oracle.DS_SINGLE)


@jax.jit
def _pair_chain(l, r, active):
    return _sponge_kernel(jnp.stack([l, r], axis=1), active, oracle.DS_PAIR)


@jax.jit
def _permutation_chain(states, active):
    return _permutation_kernel(states, active)


def hash_single_pallas(x: jnp.ndarray) -> jnp.ndarray:
    """Batched single-input hash, ds=1 (poseidon.cpp:89-91): [B,16]->[B,16]."""
    x = jnp.asarray(x, jnp.uint32)
    if not on_gpu():
        return poseidon_mod().hash_single(x)
    return _bucketed(_single_chain, x)


def hash_pair_pallas(left: jnp.ndarray, right: jnp.ndarray) -> jnp.ndarray:
    """Batched pair hash, ds=2 (poseidon.cpp:93-96)."""
    l = jnp.asarray(left, jnp.uint32)
    r = jnp.asarray(right, jnp.uint32)
    if not on_gpu():
        return poseidon_mod().hash_pair(l, r)
    return _bucketed(_pair_chain, l, r)


def hash_multiple_pallas(inputs: jnp.ndarray) -> jnp.ndarray:
    """Batched n-input hash, ds=3 (poseidon.cpp:98-101): [B,n,16]->[B,16]."""
    x = jnp.asarray(inputs, jnp.uint32)
    if not on_gpu():
        return poseidon_mod().hash_multiple(x)
    if x.shape[1] == 0:
        # Empty input: no permutation, state[1] stays 0 (SURVEY.md B.4).
        return jnp.zeros((x.shape[0], ND), jnp.uint32)
    return _bucketed(
        lambda v, a: _sponge_chain(v, a, oracle.DS_MULTIPLE), x
    )


def permutation_pallas(states: jnp.ndarray) -> jnp.ndarray:
    """Raw batched permutation on ``[B, 3, 16]`` states (any canonical
    256-bit values — the analog of batch_permutation)."""
    states = jnp.asarray(states, jnp.uint32)
    if not on_gpu():
        return poseidon_mod().permutation(states)
    return _bucketed(_permutation_chain, states)


# ---------------------------------------------------------------------------
# Packed-wire variants: inputs arrive as [.., 8] uint32 (two 16-bit digits
# per word, fr.pack16 — 32 B/element, half the raw digit bytes) and unpack
# on the device.  Callers must range-check digits < 2^16 before packing
# (fr.pack16); the coalescing engine gates and takes the unpacked path
# otherwise.
# ---------------------------------------------------------------------------


def hash_single_pallas_packed(xp: jnp.ndarray) -> jnp.ndarray:
    """ds=1 hash of PACKED ``[B, 8] uint32`` inputs; output is ``[B, 16]``
    digits.  Bit-identical to ``hash_single_pallas(fr.unpack16(xp))``."""
    return hash_single_pallas(fr.unpack16(jnp.asarray(xp, jnp.uint32)))


def hash_pair_pallas_packed(lp: jnp.ndarray, rp: jnp.ndarray) -> jnp.ndarray:
    """ds=2 hash of PACKED ``[B, 8]`` left/right operands."""
    return hash_pair_pallas(
        fr.unpack16(jnp.asarray(lp, jnp.uint32)),
        fr.unpack16(jnp.asarray(rp, jnp.uint32)),
    )


def hash_multiple_pallas_packed(xp: jnp.ndarray) -> jnp.ndarray:
    """ds=3 hash of PACKED ``[B, n, 8]`` groups."""
    return hash_multiple_pallas(fr.unpack16(jnp.asarray(xp, jnp.uint32)))


# ---------------------------------------------------------------------------
# Device-side batch loops: ``iters`` chained rounds of batched hashing in
# one jitted lax.fori_loop (each iteration's output feeds the next input,
# so no iteration can be elided or overlapped).  The body is the same
# choice as above: the kernel on a GPU, the jnp sponge elsewhere.
# ---------------------------------------------------------------------------


def _traced_sponge(x: jnp.ndarray, ds: int, active=None) -> jnp.ndarray:
    """``[B, n, 16]`` -> ``[B, 16]`` inside a trace; on the GPU only the
    first ``active[0]`` rows (default: all) are computed."""
    if on_gpu():
        return _sponge_kernel(
            x, _active(x.shape[0]) if active is None else active, ds
        )
    p = poseidon_mod()
    n = x.shape[1]
    w = max(p.PAD_WIDTH, n + (n & 1))
    x = jnp.pad(x, ((0, 0), (0, w - n), (0, 0)))
    return p._sponge_dyn(x, jnp.int32(n), jnp.int32(ds))


@functools.partial(jax.jit, static_argnums=(2,))
def _pair_loop(l, r, iters: int):
    def body(_, cur):
        return _traced_sponge(jnp.stack([cur, r], axis=1), oracle.DS_PAIR)

    return jax.lax.fori_loop(0, iters, body, l)


@functools.partial(jax.jit, static_argnums=(1,))
def _single_loop(x, iters: int):
    def body(_, cur):
        return _traced_sponge(cur[:, None, :], oracle.DS_SINGLE)

    return jax.lax.fori_loop(0, iters, body, x)


def hash_pair_pallas_loop(left, right, iters: int) -> jnp.ndarray:
    """``state_{i+1} = hash_pair(state_i, right)`` for ``iters`` rounds on
    the device; returns the final state."""
    return _pair_loop(
        jnp.asarray(left, jnp.uint32), jnp.asarray(right, jnp.uint32), iters
    )


def hash_single_pallas_loop(x, iters: int) -> jnp.ndarray:
    """``iters`` chained rounds of batched single hashing on the device."""
    return _single_loop(jnp.asarray(x, jnp.uint32), iters)


# ---------------------------------------------------------------------------
# Batch proof verification: the level walk (current node inserted at its
# proof position, siblings around it — merkle_tree.cpp:224-253) is gathers
# and selects that XLA fuses, with one sponge call per level, all inside
# one jit together with the root comparison (the analog of
# batch_verify_proofs_kernel, merkle_tree_cuda.cu:67-118).
# ---------------------------------------------------------------------------


def _verify_levels(positions, siblings, leaves, active, arity: int):
    """``positions [B, h]``, ``siblings [B, h, a-1, 16]``, ``leaves [B,
    16]`` -> recomputed roots ``[B, 16]`` (rows past ``active`` are not
    hashed on the GPU)."""
    jcol = jnp.arange(arity, dtype=jnp.int32)

    def level(lvl, cur):
        p = jax.lax.dynamic_index_in_dim(positions, lvl, axis=1, keepdims=False)
        sib = jax.lax.dynamic_index_in_dim(siblings, lvl, axis=1, keepdims=False)
        # Sibling j' = j - (j > p) fills every slot but the proof position.
        jp = jnp.clip(jcol[None, :] - (jcol[None, :] > p[:, None]), 0, arity - 2)
        gathered = jnp.take_along_axis(sib, jp[..., None], axis=1)
        group = jnp.where(
            (jcol[None, :] == p[:, None])[..., None], cur[:, None, :], gathered
        )
        return _traced_sponge(group, oracle.DS_MULTIPLE, active)

    return jax.lax.fori_loop(0, positions.shape[1], level, leaves)


@functools.partial(jax.jit, static_argnums=(5,))
def _verify_chain(positions, siblings, leaves, root, active, arity: int):
    out = _verify_levels(positions, siblings, leaves, active, arity)
    return jnp.all(out == root[None, :], axis=-1)


def verify_proofs_pallas(positions, siblings, leaves, root, arity: int):
    """Batch Merkle-proof verification in one jitted program.

    ``positions [k, h] int32``, ``siblings [k, h, a-1, 16]``,
    ``leaves [k, 16]``, ``root [16]`` -> ``[k] bool``.  On a GPU the batch
    is bucket-padded (padded rows recompute garbage and are sliced away)."""
    positions = jnp.asarray(positions, jnp.int32)
    siblings = jnp.asarray(siblings, jnp.uint32)
    leaves = jnp.asarray(leaves, jnp.uint32)
    root = jnp.asarray(root, jnp.uint32)
    k, h = positions.shape
    if h == 0:
        return jnp.all(leaves == root[None, :], axis=-1)
    if not on_gpu():
        return _verify_chain(positions, siblings, leaves, root, None, arity)
    return _bucketed(
        lambda p, s, lv, a: _verify_chain(p, s, lv, root, a, arity),
        positions, siblings, leaves,
    )
