"""cuzk_tpu — a JAX ZK hashing framework with a CUDA Poseidon kernel.

Brand-new JAX / XLA / CUDA implementation of the capabilities of the
davencyw/cuZK reference library: BN254-Fr field arithmetic, the Poseidon hash
(t=3, R_F=8, R_P=56, x^5 S-box), and n-ary (2-8) Merkle trees with proof
generation and vectorized batch verification — bit-exact against the reference
CPU semantics (see SURVEY.md Appendix A):

- field elements live as ``[..., 16] uint32`` arrays of 16-bit digits
  (re-limbed from the reference's 4x64-bit for plain jnp);
- the hot Poseidon sponge/permutation is a CUDA kernel (one state per
  thread) called through ``jax.ffi`` on the GPU, with the plain jnp path as
  the reference and the CPU path;
- Merkle trees build level-by-level under one ``jit`` (no per-level host
  round-trips), and shard across devices via ``jax.sharding`` +
  ``shard_map``.
"""

from cuzk_tpu import oracle

__version__ = "0.1.0"

__all__ = [
    "oracle",
    "poseidon",
    "merkle",
    "engine",
    "field",
    "ops",
    "parallel",
    "utils",
    "native",
    "bench",
    "__version__",
]


def __getattr__(name):
    # Lazy submodule access: ``import cuzk_tpu; cuzk_tpu.merkle`` works
    # without importing jax-heavy modules at package import time.
    if name in __all__:
        import importlib

        return importlib.import_module(f"cuzk_tpu.{name}")
    raise AttributeError(f"module 'cuzk_tpu' has no attribute {name!r}")
