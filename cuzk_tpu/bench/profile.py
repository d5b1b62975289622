"""Profiler CLI — the analog of the reference's Nsight-targeted binary
(cuda/poseidon_cuda_profiler.cpp:172-213), built on ``jax.profiler``.

Same config matrix ({1024 x 100, 8192 x 50, 32768 x 20, 65536 x 10},
poseidon_cuda_profiler.cpp:150-170) and CLI shape
(``<batch> <iters> single|pairs|both``), with an optional ``--trace-dir`` to
capture an XLA/TensorBoard trace of the kernels.

Usage:
    python -m cuzk_tpu.bench.profile 8192 50 pairs
    python -m cuzk_tpu.bench.profile --comprehensive --trace-dir /tmp/trace
"""

from __future__ import annotations

import argparse
import time

import numpy as np

# Persistent XLA compile cache: a rerun loads compiled executables.
from cuzk_tpu.utils.compilecache import enable_compile_cache

enable_compile_cache()

# poseidon_cuda_profiler.cpp:150-170
COMPREHENSIVE_CONFIGS = [(1024, 100), (8192, 50), (32768, 20), (65536, 10)]
WARMUP_ITERS = 3


def profile_hash(batch: int, iters: int, mode: str) -> dict:
    import jax
    import jax.numpy as jnp

    from cuzk_tpu.field import fr
    from cuzk_tpu.ops import hash_pair_pallas, hash_single_pallas

    rng = np.random.default_rng(0)
    l = jnp.asarray(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32))
    r = jnp.asarray(rng.integers(0, 1 << 16, (batch, fr.NDIGITS), np.uint32))

    def step():
        if mode == "single":
            return hash_single_pallas(l)
        return hash_pair_pallas(l, r)

    for _ in range(WARMUP_ITERS):  # warm-up, like the profiler's warm-up phase
        out = step()
    jax.block_until_ready(out)

    start = time.perf_counter()
    outs = [step() for _ in range(iters)]
    jax.block_until_ready(outs)
    elapsed = time.perf_counter() - start
    return {
        "mode": mode,
        "batch": batch,
        "iters": iters,
        "total_hashes": batch * iters,
        "hashes_per_s": round(batch * iters / elapsed, 1),
        "ns_per_hash": round(elapsed / (batch * iters) * 1e9, 2),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("batch", nargs="?", type=int, default=8192)
    parser.add_argument("iters", nargs="?", type=int, default=50)
    parser.add_argument(
        "mode", nargs="?", default="both", choices=["single", "pairs", "both"]
    )
    parser.add_argument("--comprehensive", action="store_true")
    parser.add_argument("--trace-dir", default=None)
    args = parser.parse_args()

    import jax

    from cuzk_tpu.utils.device import require_gpu

    require_gpu()
    configs = COMPREHENSIVE_CONFIGS if args.comprehensive else [
        (args.batch, args.iters)
    ]
    modes = ["single", "pairs"] if args.mode == "both" else [args.mode]

    def run_all():
        for batch, iters in configs:
            for mode in modes:
                print(profile_hash(batch, iters, mode))

    if args.trace_dir:
        with jax.profiler.trace(args.trace_dir):
            run_all()
        print(f"trace written to {args.trace_dir}")
    else:
        run_all()


if __name__ == "__main__":
    main()
