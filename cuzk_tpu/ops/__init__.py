"""Accelerated ops for cuzk_tpu: the Poseidon CUDA kernel behind ``jax.ffi``.

The analog of the reference's CUDA kernel layer (poseidon_cuda.cu,
poseidon_cuda_optimized.cu, field_arithmetic_cuda.cu): the jnp modules are
the reference path, the kernel is the accelerator, and the two are tested
differentially (SURVEY.md §1's CPU-oracle/GPU-accelerator invariant).
"""

from cuzk_tpu.ops.poseidon_kernel import (
    hash_single_pallas,
    hash_pair_pallas,
    hash_multiple_pallas,
    hash_single_pallas_packed,
    hash_pair_pallas_packed,
    hash_multiple_pallas_packed,
    hash_single_pallas_loop,
    hash_pair_pallas_loop,
    permutation_pallas,
    verify_proofs_pallas,
)

__all__ = [
    "hash_single_pallas",
    "hash_pair_pallas",
    "hash_multiple_pallas",
    "hash_single_pallas_packed",
    "hash_pair_pallas_packed",
    "hash_multiple_pallas_packed",
    "hash_single_pallas_loop",
    "hash_pair_pallas_loop",
    "permutation_pallas",
    "verify_proofs_pallas",
]
