"""Headline benchmark: Poseidon pair-hash throughput on one GPU (the kernel).

Mirrors the reference's "Large Scale" config (README.md:126,
benchmark.cpp:224): 1,048,576 total pair hashes, here at batch 65536 so
one call fills the card.  Reference figure: the A100 CUDA number,
2,145,027 hashes/s (README.md:134, SURVEY.md §6).

Gated by a bit-exactness check against the Python-int oracle (the analog of
the reference's verify_cuda_implementations_match benchmark gate).  Exits
non-zero without a GPU: no number is taken on the CPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""

import json
import sys
import time

import numpy as np

from cuzk_tpu.utils.compilecache import enable_compile_cache

enable_compile_cache()

BASELINE_PAIR_HASHES_PER_S = 2_145_027.0  # A100 CUDA, README.md:134


def main() -> None:
    import jax
    import jax.numpy as jnp

    from cuzk_tpu import oracle
    from cuzk_tpu.field import fr
    from cuzk_tpu.ops import hash_pair_pallas
    from cuzk_tpu.utils.device import require_gpu

    require_gpu()
    batch = 65536
    total = 1_048_576
    iters = max(1, total // batch)

    rng = np.random.default_rng(42)
    # Distinct buffers cycled per call so no call is a cache hit.
    bufs = [
        (
            jnp.asarray(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32)),
            jnp.asarray(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32)),
        )
        for _ in range(4)
    ]

    # Warm-up / compile + bit-exactness gate vs the oracle.
    out = hash_pair_pallas(*bufs[0])
    l0 = fr.array_to_ints(np.asarray(bufs[0][0][:2]))
    r0 = fr.array_to_ints(np.asarray(bufs[0][1][:2]))
    got = fr.array_to_ints(np.asarray(out[:2]))
    if got != [oracle.hash_pair(a, b) for a, b in zip(l0, r0)]:
        print(json.dumps({"metric": "poseidon_pair_hashes_per_s",
                          "error": "bit-exactness gate failed"}))
        sys.exit(1)
    jax.block_until_ready([hash_pair_pallas(*b) for b in bufs[1:]])

    start = time.perf_counter()
    outs = [hash_pair_pallas(*bufs[i % len(bufs)]) for i in range(iters)]
    jax.block_until_ready(outs)
    elapsed = time.perf_counter() - start

    dev = jax.devices()[0]
    hashes_per_s = (iters * batch) / elapsed
    print(
        json.dumps(
            {
                "metric": "poseidon_pair_hashes_per_s",
                "value": hashes_per_s,
                "unit": "hashes/s",
                "vs_baseline": hashes_per_s / BASELINE_PAIR_HASHES_PER_S,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
            }
        )
    )


if __name__ == "__main__":
    main()
