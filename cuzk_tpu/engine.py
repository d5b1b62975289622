"""Poseidon engine interface — the analog of ``IPoseidonCudaHash``
(cuda/poseidon_interface_cuda.hpp:27-47) with its two concrete
implementations (baseline CUDA / shared-memory-optimized CUDA ->
jnp reference path / CUDA kernel behind ``jax.ffi``).

The reference's interface exists so benchmarks and the Merkle layer can swap
accelerators and cross-verify them; this mirrors that contract, including
``batch_permutation`` and the stats/batch-size introspection surface.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

import jax.numpy as jnp

from cuzk_tpu import poseidon
from cuzk_tpu.utils.errors import ComputationError
from cuzk_tpu.utils.stats import HashingStats, timed


@dataclass
class PoseidonStats(HashingStats):
    """CudaPoseidonStats analog (poseidon_interface_cuda.hpp:15-21)."""

    batch_count: int = 0


class PoseidonEngine(abc.ABC):
    """Batched Poseidon accelerator interface (poseidon_interface_cuda.hpp)."""

    def __init__(self):
        self.stats = PoseidonStats()

    @abc.abstractmethod
    def batch_hash_single(self, x: jnp.ndarray) -> jnp.ndarray:
        """[B,16] -> [B,16], ds=1."""

    @abc.abstractmethod
    def batch_hash_pairs(self, l: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
        """[B,16] x2 -> [B,16], ds=2."""

    @abc.abstractmethod
    def batch_hash_multiple(self, inputs: jnp.ndarray) -> jnp.ndarray:
        """[B,n,16] -> [B,16], ds=3."""

    @abc.abstractmethod
    def batch_permutation(self, states: jnp.ndarray) -> jnp.ndarray:
        """[B,3,16] -> [B,3,16]."""

    def is_initialized(self) -> bool:
        return True

    def get_optimal_batch_size(self) -> int:
        """The reference derives this from a device probe
        (maxThreadsPerBlock, poseidon_cuda.cu:235-236); engines here derive
        it from the geometry of what they actually compile and run."""
        return 16384

    def get_max_batch_size(self) -> int:
        return 1 << 24

    def timed_hash_pairs(self, l, r):
        """Hash + record stats (the reference records per-call timings)."""
        out, sec = timed(self.batch_hash_pairs, l, r)
        self.stats.total_hashes += int(l.shape[0])
        self.stats.total_time_s += sec
        self.stats.batch_count += 1
        return out


class JnpPoseidonEngine(PoseidonEngine):
    """Reference path: batched jnp over digit-last arrays (the 'baseline'
    implementation slot, poseidon_cuda.cuh:23-59)."""

    def batch_hash_single(self, x):
        return poseidon.hash_single(x)

    def batch_hash_pairs(self, l, r):
        return poseidon.hash_pair(l, r)

    def batch_hash_multiple(self, inputs):
        return poseidon.hash_multiple(inputs)

    def batch_permutation(self, states):
        return poseidon.permutation(states)


class PallasPoseidonEngine(PoseidonEngine):
    """Accelerated path: the ``cuzk_tpu.ops`` API — the CUDA kernel on a
    GPU, the jnp path elsewhere (the 'optimized' implementation slot,
    poseidon_cuda_optimized.cuh:26-62)."""

    def batch_hash_single(self, x):
        from cuzk_tpu.ops import hash_single_pallas

        return hash_single_pallas(x)

    def batch_hash_pairs(self, l, r):
        from cuzk_tpu.ops import hash_pair_pallas

        return hash_pair_pallas(l, r)

    def batch_hash_multiple(self, inputs):
        from cuzk_tpu.ops import hash_multiple_pallas

        return hash_multiple_pallas(inputs)

    def batch_permutation(self, states):
        from cuzk_tpu.ops import permutation_pallas

        return permutation_pallas(states)

    # Packed-wire surface (fr.pack16 [B, 8] operands, 32 B/element): used
    # by the coalescing engine to halve H2D upload bytes.  Digits MUST be
    # range-checked < 2^16 by the caller (fr.pack16 docstring).
    def batch_hash_single_packed(self, xp):
        from cuzk_tpu.ops import hash_single_pallas_packed

        return hash_single_pallas_packed(xp)

    def batch_hash_pairs_packed(self, lp, rp):
        from cuzk_tpu.ops import hash_pair_pallas_packed

        return hash_pair_pallas_packed(lp, rp)

    def batch_hash_multiple_packed(self, xp):
        from cuzk_tpu.ops import hash_multiple_pallas_packed

        return hash_multiple_pallas_packed(xp)

    def get_optimal_batch_size(self) -> int:
        """One coalescing flush (65,536 states): with one state per thread
        in 128-thread blocks that is 512 blocks, several per SM on a
        132-SM H100, so the launch fills the card."""
        return 65536


class DeferredHashes:
    """Handle for queued hashes; ``get()`` forces the owning engine's flush
    and returns this call's ``[B, 16]`` results.

    The flush stores (fused output, offset, count); the per-call slice is
    taken LAZILY at first ``get()``, so a flush stays one dispatch however
    many calls it serves.

    Two consequences of laziness: each un-``get()`` handle keeps the WHOLE
    fused flush output alive (its ``_src`` references the shared buffer —
    call ``get()`` on handles you need and drop the rest if device memory
    matters), and each first ``get()`` dispatches one slice op (deferred
    off the flush critical path, not eliminated)."""

    __slots__ = ("_engine", "_value", "_src")

    def __init__(self, engine: "CoalescingPoseidonEngine"):
        self._engine = engine
        self._value = None
        self._src = None

    @property
    def ready(self) -> bool:
        """True once a flush has produced this call's results."""
        return self._value is not None or self._src is not None

    def get(self) -> jnp.ndarray:
        if not self.ready:
            self._engine.flush()
        if self._value is None:
            if self._src is None:  # flush restored the queue on a failure
                raise ComputationError(
                    "deferred hashes were not materialized by flush()"
                )
            out, off, n = self._src
            self._value = out[off : off + n]
            self._src = None
        return self._value


class CoalescingPoseidonEngine(PoseidonEngine):
    """Deferred/coalescing front-end over another engine: ``async_*`` calls
    enqueue host-side and return :class:`DeferredHashes`; ONE fused device
    dispatch per flush serves every queued call.

    This is the answer to the reference's Small/Medium-Scale batch configs
    (512 x 10K, 1024 x 100K; benchmark.cpp:213-235): a 512-element batch
    fills four 128-thread blocks of a 132-SM card, and every dispatch pays
    a fixed launch and transfer cost — the analog of the reference's own
    per-call cudaMalloc+H2D+sync overhead (poseidon_cuda.cu:279-471), which
    it pays per batch rather than amortizing.  Coalescing keeps the exact
    per-call semantics (queues are keyed per op kind and width, so every
    element hashes with its own domain separator) while the device sees
    large batches.

    Inputs are staged as host numpy (a device-array argument pays one
    readback at enqueue): this engine is the host-side front door for
    request-at-a-time workloads — verifiers, RPC servers — not a wrapper
    for already-device-resident tensors (call the inner engine directly
    for those).
    """

    def __init__(self, inner: PoseidonEngine = None, flush_elems: int = 65536):
        super().__init__()
        self.inner = inner if inner is not None else PallasPoseidonEngine()
        self.flush_elems = flush_elems
        # queue key -> list of (host_arrays..., DeferredHashes)
        self._queues: dict = {}
        self._pending = 0
        #: Last exception swallowed by a threshold flush (None when the
        #: last flush succeeded) — so a persistent backend failure is
        #: observable without waiting for an explicit flush()/get().
        self.last_flush_error: "BaseException | None" = None

    # -- async surface ----------------------------------------------------
    def _enqueue(self, key, arrays) -> DeferredHashes:
        import numpy as np

        d = DeferredHashes(self)
        self._queues.setdefault(key, []).append(
            tuple(np.asarray(a, np.uint32) for a in arrays) + (d,)
        )
        self._pending += int(arrays[0].shape[0])
        if self._pending >= self.flush_elems:
            # The threshold flush is an optimization, so a dispatch
            # failure here is DEFERRED: raising from the enqueue site
            # would lose the caller's handle before they ever receive it
            # (the queue keeps the work, but nobody could get() it).
            # flush() restored the queue, so a persistent failure
            # surfaces at the caller's explicit flush()/get() instead —
            # but never silently: it is logged once and kept on
            # ``last_flush_error``.
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 — deferred, see above
                if self.last_flush_error is None:
                    import logging

                    logging.getLogger(__name__).warning(
                        "deferred threshold-flush failure (queue kept; "
                        "will surface at the next explicit flush/get): %r",
                        e,
                    )
                self.last_flush_error = e
        return d

    def async_hash_single(self, x) -> DeferredHashes:
        return self._enqueue("single", (x,))

    def async_hash_pairs(self, l, r) -> DeferredHashes:
        return self._enqueue("pairs", (l, r))

    def async_hash_multiple(self, inputs) -> DeferredHashes:
        return self._enqueue(("multiple", int(inputs.shape[1])), (inputs,))

    def flush(self) -> None:
        """One fused device dispatch per (kind, width) with queued work.

        A failed dispatch restores its queue before the exception
        propagates, so queued :class:`DeferredHashes` are never orphaned:
        a later ``get()`` retries the dispatch instead of silently
        returning ``None`` (round-2 advisor finding)."""
        import numpy as np

        for key in list(self._queues):
            calls = self._queues.pop(key)
            n_elems = sum(c[0].shape[0] for c in calls)
            try:
                kind = key if isinstance(key, str) else key[0]
                cols = list(zip(*calls))
                deferreds = cols[-1]
                stacked = [np.concatenate(c, axis=0) for c in cols[:-1]]
                # Packed wire format (fr.pack16, 32 B/element — half the
                # raw digit bytes) whenever the inner engine supports it
                # and every digit is canonical 16-bit; non-canonical
                # digits would alias under packing (range gate, same
                # discipline as the dedup verify upload), so those
                # flushes take the full-width path and stay bit-exact.
                packed = hasattr(
                    self.inner, "batch_hash_single_packed"
                ) and all(int(s.max(initial=0)) >> 16 == 0 for s in stacked)
                if packed:
                    from cuzk_tpu.field import fr

                    stacked = [fr.pack16(s) for s in stacked]
                # kind is "single" | "pairs" | "multiple" (queue key).
                fn = getattr(
                    self.inner,
                    f"batch_hash_{kind}{'_packed' if packed else ''}",
                )
                out = fn(*(jnp.asarray(s) for s in stacked))
            except BaseException:
                self._queues[key] = calls  # keep the work; get() can retry
                raise
            self.last_flush_error = None
            self._pending -= n_elems
            off = 0
            for arrs0, d in zip(cols[0], deferreds):
                n = arrs0.shape[0]
                d._src = (out, off, n)  # sliced lazily at first get()
                off += n
            self.stats.total_hashes += off
            self.stats.batch_count += 1

    # -- synchronous PoseidonEngine surface (enqueue + immediate force) ----
    def batch_hash_single(self, x):
        return self.async_hash_single(x).get()

    def batch_hash_pairs(self, l, r):
        return self.async_hash_pairs(l, r).get()

    def batch_hash_multiple(self, inputs):
        return self.async_hash_multiple(inputs).get()

    def batch_permutation(self, states):
        return self.inner.batch_permutation(states)


def verify_engines_match(batch: int = 64, seed: int = 7) -> bool:
    """Cross-implementation verification gate
    (verify_cuda_implementations_match, poseidon_cuda_benchmarks.cpp:137-259):
    deterministic inputs, elementwise equality across engines, over EVERY
    exported accelerated op — single/pair (the reference gate's scope) plus
    ``hash_multiple`` (the op the whole Merkle build/verify runs on) and the
    raw ``permutation`` (exported API)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    l = jnp.asarray(rng.integers(0, 1 << 16, (batch, 16), np.uint32))
    r = jnp.asarray(rng.integers(0, 1 << 16, (batch, 16), np.uint32))
    groups = jnp.asarray(rng.integers(0, 1 << 16, (batch, 5, 16), np.uint32))
    states = jnp.asarray(rng.integers(0, 1 << 16, (batch, 3, 16), np.uint32))
    a, b = JnpPoseidonEngine(), PallasPoseidonEngine()

    return (
        bool(np.array_equal(a.batch_hash_pairs(l, r), b.batch_hash_pairs(l, r)))
        and bool(np.array_equal(a.batch_hash_single(l), b.batch_hash_single(l)))
        and bool(
            np.array_equal(
                a.batch_hash_multiple(groups), b.batch_hash_multiple(groups)
            )
        )
        and bool(
            np.array_equal(a.batch_permutation(states), b.batch_permutation(states))
        )
    )
