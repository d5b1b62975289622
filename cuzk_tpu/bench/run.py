"""Benchmark suite: Poseidon hash throughput, Merkle builds, proof batches.

Mirrors the reference's harness (SURVEY.md §6):
- ``poseidon_benchmark`` configs {10K x 512, 100K x 1024, 1M x 4096}
  (benchmark.cpp:213-235) for single & pair hashing;
- Merkle 50K-leaf build + 5K-proof batch verification (README.md:18-19);
- cross-implementation verification gates benchmarking, like
  ``verify_cuda_implementations_match`` (poseidon_cuda_benchmarks.cpp:137-259).

Timing follows the JAX discipline: compile/warm-up outside the timer,
``block_until_ready`` inside.  Results print as JSON lines plus a human table.
Every suite needs a GPU: a number is never taken on the CPU.

Usage:
    python -m cuzk_tpu.bench.run --suite all
    python -m cuzk_tpu.bench.run --suite poseidon --path kernel --mode pairs
    python -m cuzk_tpu.bench.run --suite merkle --leaves 50000 --arity 4
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List

import numpy as np

# Persistent XLA compile cache (must be set before jax initializes).
from cuzk_tpu.utils.compilecache import enable_compile_cache

enable_compile_cache()

# A100 reference numbers (README.md:131-143, SURVEY.md §6).
BASELINES = {
    "poseidon_pairs_hashes_per_s": 2_145_027.0,
    "poseidon_single_hashes_per_s": 1_751_596.0,
    "merkle_build_50k_ms": 282.0,
    "batch_verify_5k_ms": 14.8,
}


def time_fn_stats(
    fn: Callable, *args, iters: int = 10, warmup: int = 2, groups: int = 5
) -> Dict:
    """Grouped wall timing: warm-up (compiles), then the timed loop split
    into up to ``groups`` chunks, each ended by ``jax.block_until_ready``.
    Within a chunk dispatches stay pipelined, while the per-chunk means
    give order statistics, so every suite row can carry ``p50``/``min``
    alongside the mean.  Returns ``{"mean_s", "p50_s", "min_s"}`` seconds
    per iteration."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    g = max(1, min(iters, groups))
    base, extra = divmod(iters, g)
    per, total = [], 0.0
    for i in range(g):
        n = base + (1 if i < extra else 0)
        start = time.perf_counter()
        outs = [fn(*args) for _ in range(n)]
        jax.block_until_ready(outs)
        dt = time.perf_counter() - start
        total += dt
        per.append(dt / n)
    return {
        "mean_s": total / iters,
        "p50_s": float(np.median(per)),
        "min_s": min(per),
    }


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2) -> float:
    """Mean seconds per iteration (see :func:`time_fn_stats`)."""
    return time_fn_stats(fn, *args, iters=iters, warmup=warmup)["mean_s"]


def _rand_digits(n: int, seed: int) -> np.ndarray:
    from cuzk_tpu.field import fr

    rng = np.random.default_rng(seed)
    # Random 256-bit canonical values; hashing reduces them on absorb.
    return rng.integers(0, 1 << 16, (n, fr.NDIGITS), dtype=np.uint32)


def _hash_fns(path: str):
    if path == "kernel":
        from cuzk_tpu import ops

        return ops.hash_single_pallas, ops.hash_pair_pallas
    from cuzk_tpu import poseidon

    return poseidon.hash_single, poseidon.hash_pair


def verify_paths_match(batch: int = 256) -> bool:
    """Gate: jnp and kernel paths must agree bit-exactly before benchmarking
    (the reference's cross-implementation verification), over every exported
    accelerated op: pair/single hashing, ``hash_multiple`` (what the Merkle
    build and verify run on) and the raw ``permutation``."""
    import jax.numpy as jnp

    from cuzk_tpu import ops, poseidon
    from cuzk_tpu.field import fr

    l = jnp.asarray(_rand_digits(batch, 7))
    r = jnp.asarray(_rand_digits(batch, 8))
    groups = jnp.asarray(
        _rand_digits(batch * 4, 9).reshape(batch, 4, fr.NDIGITS)
    )
    states = jnp.asarray(
        _rand_digits(batch * 3, 10).reshape(batch, 3, fr.NDIGITS)
    )
    return (
        bool(
            np.array_equal(
                np.asarray(ops.hash_pair_pallas(l, r)),
                np.asarray(poseidon.hash_pair(l, r)),
            )
        )
        and bool(
            np.array_equal(
                np.asarray(ops.hash_single_pallas(l)),
                np.asarray(poseidon.hash_single(l)),
            )
        )
        and bool(
            np.array_equal(
                np.asarray(ops.hash_multiple_pallas(groups)),
                np.asarray(poseidon.hash_multiple(groups)),
            )
        )
        and bool(
            np.array_equal(
                np.asarray(ops.permutation_pallas(states)),
                np.asarray(poseidon.permutation(states)),
            )
        )
    )


def bench_poseidon(
    batch: int,
    total: int,
    mode: str = "pairs",
    path: str = "kernel",
    pipeline: bool = None,
) -> Dict:
    """One reference config (benchmark.cpp:213-235): ``total`` hashes fed
    ``batch`` at a time.

    Small/medium batches default to the coalescing engine
    (`engine.CoalescingPoseidonEngine`): calls arrive host-side batch by
    batch — exactly the reference's loop — and fuse into large device
    dispatches, so the fixed dispatch cost is paid per flush instead of
    per 512-element call.  Host staging + uploads stay inside
    the timed region (the reference's numbers include its per-call H2D/D2H
    copies too).  ``pipeline=False`` forces the synchronous device-resident
    path (the large-batch default)."""
    import jax
    import jax.numpy as jnp

    iters = max(1, total // batch)
    if pipeline is None:
        pipeline = path == "kernel" and batch <= 2048
    if pipeline:
        from cuzk_tpu import engine as engine_mod

        l_h = _rand_digits(batch, 42)
        r_h = _rand_digits(batch, 43)
        eng = engine_mod.CoalescingPoseidonEngine()

        def run_config():
            if mode == "pairs":
                outs = [eng.async_hash_pairs(l_h, r_h) for _ in range(iters)]
            else:
                outs = [eng.async_hash_single(l_h) for _ in range(iters)]
            eng.flush()
            return outs[-1].get()

        st = time_fn_stats(run_config, iters=3, warmup=2, groups=3)
        st = {k: v / iters for k, v in st.items()}
    else:
        single_fn, pair_fn = _hash_fns(path)
        l = jnp.asarray(_rand_digits(batch, 42))
        r = jnp.asarray(_rand_digits(batch, 43))
        if mode == "pairs":
            st = time_fn_stats(pair_fn, l, r, iters=iters, warmup=2)
        else:
            st = time_fn_stats(single_fn, l, iters=iters, warmup=2)
    sec = st["mean_s"]
    per_hash_ns = sec / batch * 1e9
    hps = batch / sec
    key = f"poseidon_{mode}_hashes_per_s"
    return {
        "suite": "poseidon",
        "mode": mode,
        "path": path,
        "pipelined": bool(pipeline),
        "batch": batch,
        "total_hashes": iters * batch,
        "ns_per_hash": round(per_hash_ns, 2),
        "hashes_per_s": round(hps, 1),
        "hashes_per_s_p50": round(batch / st["p50_s"], 1),
        "hashes_per_s_best": round(batch / st["min_s"], 1),
        "vs_baseline": round(hps / BASELINES[key], 4) if key in BASELINES else None,
    }


def bench_poseidon_resident(
    batch: int, total: int, mode: str = "pairs", samples: int = 3
) -> Dict:
    """Chip-capability row for one reference config: operands
    device-resident and the batch loop ON DEVICE
    (``ops.hash_*_pallas_loop``: a ``lax.fori_loop`` whose every iteration
    feeds its output into the next input, so no iteration can be elided or
    overlapped) — one dispatch + one readback for the whole config.  This
    pins what the CHIP does at this batch granularity with zero
    interconnect in the timed region; the per-iteration grid launch is
    still paid per batch, exactly as a device-resident caller would pay
    it.  The companion host-fed number is ``bench_poseidon``'s coalesced
    row."""
    import jax.numpy as jnp

    from cuzk_tpu import ops, poseidon

    iters = max(1, total // batch)
    l = jnp.asarray(_rand_digits(batch, 42))
    r = jnp.asarray(_rand_digits(batch, 43))

    def loop(n):
        return (
            ops.hash_pair_pallas_loop(l, r, n)
            if mode == "pairs"
            else ops.hash_single_pallas_loop(l, n)
        )

    # Bit-exactness gate: two chained device iterations must equal two
    # jnp-path applications (the loop IS repeated hashing, not an
    # approximation of it).
    want = (
        poseidon.hash_pair(poseidon.hash_pair(l, r), r)
        if mode == "pairs"
        else poseidon.hash_single(poseidon.hash_single(l))
    )
    if not np.array_equal(np.asarray(loop(2)), np.asarray(want)):
        raise SystemExit("device loop diverges from jnp path; aborting")

    # SLOPE timing: timing the loop at N and 2N device iterations and
    # differencing cancels every constant term (dispatch, readback) — what
    # remains is per-batch device time.  N is at least 64 so the delta is
    # well above timer jitter even for short configs.
    n_slope = max(iters, 64)
    st1 = time_fn_stats(lambda: loop(n_slope), iters=samples, warmup=1,
                        groups=samples)
    st2 = time_fn_stats(lambda: loop(2 * n_slope), iters=samples, warmup=1,
                        groups=samples)
    sec = max((st2["min_s"] - st1["min_s"]) / n_slope, 1e-9)  # per batch
    key = f"poseidon_{mode}_hashes_per_s"
    hps = batch / sec
    return {
        "suite": "poseidon_resident",
        "mode": mode,
        "batch": batch,
        "total_hashes": iters * batch,
        "device_loop_iters": iters,
        "ns_per_hash": round(sec / batch * 1e9, 2),
        "hashes_per_s": round(hps, 1),
        "config_ms_incl_readback": round(st1["min_s"] * 1e3, 2),
        "vs_baseline": round(hps / BASELINES[key], 4) if key in BASELINES else None,
    }


def bench_merkle_build(n_leaves: int, arity: int, iters: int = 3) -> Dict:
    import jax
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    leaves = jnp.asarray(_rand_digits(n_leaves, 11))

    def build(lv):
        return merkle.build_tree_levels(lv, arity)[-1]

    st = time_fn_stats(build, leaves, iters=iters, warmup=1, groups=iters)
    sec = st["mean_s"]
    ms = sec * 1e3
    out = {
        "suite": "merkle_build",
        "leaves": n_leaves,
        "arity": arity,
        "build_ms": round(ms, 2),
        "build_ms_p50": round(st["p50_s"] * 1e3, 2),
        "build_ms_min": round(st["min_s"] * 1e3, 2),
        "leaves_per_s": round(n_leaves / sec, 1),
    }
    if n_leaves == 50_000:
        out["vs_baseline"] = round(BASELINES["merkle_build_50k_ms"] / ms, 4)
    return out


def bench_incremental_update(
    n_leaves: int, arity: int, k: int = 64, iters: int = 10
) -> Dict:
    """Incremental batched leaf update vs full rebuild (beyond-parity: the
    reference's update_leaf IS a full rebuild, merkle_tree.cpp:290-301).
    Times ``update_leaves`` of ``k`` random leaves on an ``n_leaves`` tree
    against rebuilding it, with a root consistency check."""
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    rng = np.random.default_rng(29)
    leaves = jnp.asarray(_rand_digits(n_leaves, 28))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = rng.choice(n_leaves, size=k, replace=False)
    vals = jnp.asarray(_rand_digits(k, 30))

    def update(i, v):
        t2 = merkle.NaryMerkleTree(config=merkle.MerkleConfig(arity))
        t2._levels, t2._num_leaves = list(tree.levels), n_leaves
        t2.update_leaves(i, v)
        return t2._levels[-1]

    def rebuild(lv):
        return merkle.build_tree_levels(lv, arity)[-1]

    sec_up = time_fn(update, idx, vals, iters=iters, warmup=1)
    updated = jnp.asarray(leaves).at[jnp.asarray(idx)].set(vals)
    sec_rb = time_fn(rebuild, updated, iters=3, warmup=1)
    consistent = bool(
        np.array_equal(np.asarray(update(idx, vals)), np.asarray(rebuild(updated)))
    )
    return {
        "suite": "incremental_update",
        "leaves": n_leaves,
        "arity": arity,
        "updates": k,
        "update_ms": round(sec_up * 1e3, 2),
        "rebuild_ms": round(sec_rb * 1e3, 2),
        "speedup_vs_rebuild": round(sec_rb / sec_up, 1),
        "roots_consistent": consistent,
    }


def bench_merkle_compare(n_leaves: int, arity: int, iters: int = 3) -> Dict:
    """Reference-path (jnp, the 'CPU' slot) vs accelerated (CUDA kernel)
    side-by-side build with an IN-BENCH consistency check — the analog of
    ``benchmark_cuda_vs_cpu_merkle`` (merkle_tree_cuda.cu:648-856) and
    ``benchmark_cuda_vs_cpu_poseidon`` (poseidon_cuda_benchmarks.cpp:119-135),
    which cross-check the two trees inside the benchmark run and report a
    speedup table."""
    import jax.numpy as jnp

    from cuzk_tpu import merkle
    from cuzk_tpu.field import fr

    leaves_h = _rand_digits(n_leaves, 11)
    leaves = jnp.asarray(leaves_h)

    def build_fast(lv):
        return merkle.build_tree_levels(lv, arity)[-1]

    padded = merkle.padded_leaf_count(n_leaves, arity)
    pad_rows = np.broadcast_to(
        np.array(merkle._empty_hash_digits(arity), np.uint32),
        (padded - n_leaves, fr.NDIGITS),
    )
    leaves_p = jnp.asarray(np.concatenate([leaves_h, pad_rows], axis=0))

    def build_reference(lv):
        # Host-driven level loop on the jnp path: the 'CPU implementation'
        # slot of the reference's comparison.
        with merkle.engine_path("jnp"):
            return merkle._build_levels(lv, arity)[-1]

    sec_fast = time_fn(build_fast, leaves, iters=iters, warmup=1)
    sec_ref = time_fn(build_reference, leaves_p, iters=1, warmup=1)
    root_fast = np.asarray(build_fast(leaves))
    root_ref = np.asarray(build_reference(leaves_p))
    consistent = bool(np.array_equal(root_fast, root_ref))
    return {
        "suite": "merkle_compare",
        "leaves": n_leaves,
        "arity": arity,
        "accelerated_ms": round(sec_fast * 1e3, 2),
        "reference_path_ms": round(sec_ref * 1e3, 2),
        "speedup": round(sec_ref / sec_fast, 2),
        "trees_consistent": consistent,
    }


def bench_batch_verify(
    n_proofs: int,
    n_leaves: int,
    arity: int,
    iters: int = 10,
    dedupe: bool = None,
) -> Dict:
    """Times the reference's batch-verify semantics: proofs on the host
    (as a verifier receives them), one all-or-nothing bool out
    (merkle_tree_cuda.cu:341-465).  The deduplicated schedule build is
    inside the timed region — it is part of the verify, the same way the
    reference's CSR flattening + H2D copies are part of its 14.8 ms."""
    import jax
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    leaves = jnp.asarray(_rand_digits(n_leaves, 13))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = np.arange(n_proofs) % n_leaves
    pos, sib = tree.generate_batch_proofs(idx)
    pos, sib = np.asarray(pos), np.asarray(sib)  # host-side proofs
    proved = tree.levels[0][jnp.asarray(idx)]
    root = tree.get_root_hash()

    def verify(p, s, lv, rt):
        return np.bool_(merkle.verify_all(p, s, lv, rt, arity, dedupe=dedupe))

    ok = bool(verify(pos, sib, proved, root))

    # In-bench consistency gate, like the reference's CPU<->GPU cross-check
    # inside benchmark_cuda_vs_cpu_merkle (merkle_tree_cuda.cu:648-856): on
    # a subset, the accelerated per-proof verifier, the jnp reference path,
    # and the dedup schedule must all agree.
    k_sub = min(64, n_proofs)
    pos_s, sib_s, proved_s = pos[:k_sub], sib[:k_sub], proved[:k_sub]
    kernel_sub = np.asarray(
        merkle.verify_proofs(pos_s, sib_s, proved_s, root, arity)
    )
    with merkle.engine_path("jnp"):
        jnp_sub = np.asarray(
            merkle._verify_batch(
                arity,
                jnp.asarray(pos_s, jnp.int32),
                jnp.asarray(sib_s, jnp.uint32),
                proved_s,
                root,
            )
        )
    dedup_sub = bool(
        merkle.verify_all(pos_s, sib_s, proved_s, root, arity, dedupe=True)
    )
    consistent = (
        bool(np.array_equal(kernel_sub, jnp_sub))
        and dedup_sub == bool(kernel_sub.all())
    )
    if not consistent:
        raise SystemExit(
            "batch-verify paths disagree (kernel vs jnp vs dedup); aborting"
        )
    st = time_fn_stats(
        verify, pos, sib, proved, root, iters=iters, warmup=1, groups=iters
    )
    sec = st["mean_s"]
    ms = sec * 1e3
    out = {
        "suite": "batch_verify",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "all_valid": ok,
        "paths_consistent": consistent,
        "verify_ms": round(ms, 2),
        "verify_ms_p50": round(st["p50_s"] * 1e3, 2),
        "verify_ms_min": round(st["min_s"] * 1e3, 2),
        "proofs_per_s": round(n_proofs / sec, 1),
    }
    if n_proofs == 5_000:
        out["vs_baseline"] = round(BASELINES["batch_verify_5k_ms"] / ms, 4)
        out["vs_baseline_min"] = round(
            BASELINES["batch_verify_5k_ms"] / (st["min_s"] * 1e3), 4
        )
    return out


def bench_proof_generation(
    n_proofs: int, n_leaves: int, arity: int, iters: int = 10
) -> Dict:
    """Times ``generate_batch_proofs`` — the analog of the reference's
    proof-generation benchmarks (MerkleUtils::benchmark_tree fills
    proof_generation_time_ms, merkle_tree.cpp:399-440;
    benchmark_cuda_proof_generation, merkle_tree_cuda.cuh:128-129).
    Proofs are gathered on device and landed to host numpy (a verifier
    consumes them host-side, like the reference's vector<MerkleProof>)."""
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    leaves = jnp.asarray(_rand_digits(n_leaves, 13))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    rng = np.random.default_rng(19)
    idx = rng.integers(0, n_leaves, n_proofs)

    def gen(ix):
        pos, sib = tree.generate_batch_proofs(ix)
        return np.asarray(pos), np.asarray(sib)

    st = time_fn_stats(gen, idx, iters=iters, warmup=1, groups=iters)
    sec = st["mean_s"]
    pos, sib = gen(idx)
    return {
        "suite": "proof_generation",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "proof_levels": int(pos.shape[1]),
        "proof_bytes": int(pos.nbytes + sib.nbytes),
        "gen_ms": round(sec * 1e3, 2),
        "gen_ms_p50": round(st["p50_s"] * 1e3, 2),
        "gen_ms_min": round(st["min_s"] * 1e3, 2),
        "proofs_per_s": round(n_proofs / sec, 1),
    }


def bench_tree_matrix(configs=((1024, 2), (4096, 4), (50_000, 8))) -> List[Dict]:
    """merkle.benchmark_tree over a config matrix: one JSON line per
    (leaves, arity) with build/proof-gen/verify phases — the
    TreeBenchmarkResult surface exercised end-to-end."""
    from dataclasses import asdict

    from cuzk_tpu import merkle

    out = []
    for n, a in configs:
        r = asdict(merkle.benchmark_tree(n, a, num_proofs=100))
        r["suite"] = "benchmark_tree"
        out.append(r)
        print(json.dumps(r))
    return out


def bench_batch_verify_resident(
    n_proofs: int,
    n_leaves: int,
    arity: int,
    iters: int = 20,
) -> Dict:
    """Phase-decomposed 5K-proof verify: separates the host schedule, the
    upload and the device hash work.

    The end-to-end ``bench_batch_verify`` number blends three phases; this
    benchmark times each alone:
      - ``schedule_ms``: host-side dedup schedule build + packing
        (numpy only, no device involvement) — merkle._dedup_pack;
      - ``upload_ms``: staging the packed uint32 buffer on device
        (one H2D transfer of ``upload_bytes``);
      - ``device_ms``: the fused verify dispatch with the schedule already
        device-resident, iters dispatches pipelined with ONE final flag
        readback — per-iter cost is pure device hash work with the
        host<->device hop amortized to hop/iters.  This is the analog of
        the reference's kernel-only time (its 14.8 ms also includes H2D +
        D2H, merkle_tree_cuda.cu:403-461, so beating 14.8 on device_ms +
        upload_ms + readback is the honest comparison);
      - ``device_sync_ms``: same dispatch but reading the flags back every
        iteration — device work plus one round-trip, i.e. the minimum
        latency a caller who needs the bool immediately pays.
    """
    import jax
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    leaves = jnp.asarray(_rand_digits(n_leaves, 13))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = np.arange(n_proofs) % n_leaves
    pos, sib = tree.generate_batch_proofs(idx)
    pos = np.asarray(pos, np.int32)
    sib = np.asarray(sib, np.uint32)
    proved = np.asarray(tree.levels[0][jnp.asarray(idx)], np.uint32)
    root = np.asarray(tree.get_root_hash(), np.uint32)

    # Phase 1: host schedule build + packing (pure numpy).
    wire = merkle._dedup_pack(pos, sib, proved, root, arity)
    if wire is None:
        raise SystemExit("dedup pack declined on honest proofs; aborting")
    packed_np = wire.packed

    def pack():
        return merkle._dedup_pack(pos, sib, proved, root, arity)

    sched_st = time_fn_stats(pack, iters=iters, warmup=0, groups=iters)

    # Phase 2: upload (H2D of the single packed buffer).  jax.device_put
    # creates a fresh buffer each call; warm-up outside the timer.  Two
    # deep groups, so the per-group wait amortizes: in the real verify
    # flow the upload is one link of a schedule->upload->dispatch->flags
    # chain with a single wait at the end.
    up_st = time_fn_stats(
        lambda: jax.device_put(packed_np), iters=4 * iters, warmup=1,
        groups=2,
    )

    # Phase 3: device-resident fused verify.
    packed_dev = jax.device_put(packed_np)

    def dispatch():
        return merkle._dedup_verify_fused(
            arity, wire.sizes, wire.kb, wire.tb, wire.lm16, packed_dev
        )

    flags = np.asarray(dispatch()[0])
    ok = bool(flags[0]) and bool(flags[1])
    # Pipelined: dispatches queue asynchronously; each group of ``iters``
    # dispatches ends in one wait; three groups give the order statistics.
    dev_st = time_fn_stats(dispatch, iters=3 * iters, warmup=1, groups=3)
    # Synchronous: flags read back each iteration.
    t0 = time.perf_counter()
    for _ in range(iters):
        np.asarray(dispatch()[0])
    device_sync_ms = (time.perf_counter() - t0) / iters * 1e3

    schedule_ms = sched_st["mean_s"] * 1e3
    upload_ms = up_st["mean_s"] * 1e3
    device_ms = dev_st["mean_s"] * 1e3
    software_min = (
        sched_st["min_s"] + up_st["min_s"] + dev_st["min_s"]
    ) * 1e3
    out = {
        "suite": "batch_verify_resident",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "all_valid": ok,
        "iters": iters,
        "schedule_ms": round(schedule_ms, 2),
        "schedule_ms_min": round(sched_st["min_s"] * 1e3, 2),
        "upload_bytes": int(packed_np.nbytes),
        "upload_ms": round(upload_ms, 2),
        "upload_ms_min": round(up_st["min_s"] * 1e3, 2),
        "device_ms": round(device_ms, 3),
        "device_ms_min": round(dev_st["min_s"] * 1e3, 3),
        "device_sync_ms": round(device_sync_ms, 2),
        "software_ms": round(schedule_ms + upload_ms + device_ms, 2),
        "software_ms_min": round(software_min, 2),
        "unique_jobs": int(sum(wire.sizes)),
    }
    if n_proofs == 5_000:
        out["vs_baseline_device"] = round(
            BASELINES["batch_verify_5k_ms"] / device_ms, 2
        )
        out["vs_baseline_software"] = round(
            BASELINES["batch_verify_5k_ms"] / out["software_ms"], 4
        )
        out["vs_baseline_software_min"] = round(
            BASELINES["batch_verify_5k_ms"] / software_min, 4
        )
    return out


def bench_batch_verify_tampered(
    n_proofs: int, n_leaves: int, arity: int, iters: int = 5
) -> Dict:
    """Failure-isolation economics: ONE tampered proof in an otherwise
    valid batch.  Without isolation this is the dedup path's worst case —
    the dedup pass PLUS a full per-proof recompute of all k proofs; the
    isolation path maps the failed checks to the suspect proofs and
    re-verifies only those.  The row also
    records the full exact-path time for comparison and pins WHICH proof
    was reported invalid."""
    import jax.numpy as jnp

    from cuzk_tpu import merkle

    leaves = jnp.asarray(_rand_digits(n_leaves, 13))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    idx = np.arange(n_proofs) % n_leaves
    pos, sib = tree.generate_batch_proofs(idx)
    pos = np.asarray(pos, np.int32)
    sib = np.asarray(sib, np.uint32)
    proved = np.asarray(tree.levels[0][jnp.asarray(idx)], np.uint32)
    root = np.asarray(tree.get_root_hash(), np.uint32)
    bad = proved.copy()
    tampered = n_proofs // 2
    bad[tampered, 0] ^= 1

    res = merkle.verify_each(pos, sib, bad, root, arity, dedupe=True)
    flagged = np.flatnonzero(~res)
    want = np.asarray(merkle.verify_proofs(pos, sib, bad, root, arity))
    if not np.array_equal(res, want):
        raise SystemExit("isolated verdicts diverge from exact path; aborting")

    def isolated():
        return merkle.verify_each(pos, sib, bad, root, arity, dedupe=True)

    def exact():
        return np.asarray(merkle.verify_proofs(pos, sib, bad, root, arity))

    st_iso = time_fn_stats(isolated, iters=iters, warmup=1, groups=iters)
    st_ex = time_fn_stats(exact, iters=iters, warmup=1, groups=iters)
    honest = time_fn_stats(
        lambda: merkle.verify_each(pos, sib, proved, root, arity, dedupe=True),
        iters=iters, warmup=1, groups=iters,
    )
    return {
        "suite": "batch_verify_tampered",
        "proofs": n_proofs,
        "leaves": n_leaves,
        "arity": arity,
        "tampered_index": tampered,
        "flagged": [int(i) for i in flagged[:8]],
        "isolated_ms": round(st_iso["mean_s"] * 1e3, 2),
        "isolated_ms_min": round(st_iso["min_s"] * 1e3, 2),
        "honest_ms": round(honest["mean_s"] * 1e3, 2),
        "full_exact_ms": round(st_ex["mean_s"] * 1e3, 2),
        "isolated_vs_exact_speedup": round(
            st_ex["mean_s"] / st_iso["mean_s"], 2
        ),
    }


def bench_merkle_sweep(
    arities=range(2, 9), sizes=(64, 256, 1024, 4096), proofs: int = 256
) -> List[Dict]:
    """Arity 2-8 and leaf-count sweep, mirroring the reference's
    benchmark-as-test tables (test_merkle_benchmark.cpp:39-235 sweeps
    arities 2-8 and sizes 64-4096; test_merkle_benchmark_cuda.cpp adds
    proof-batch sweeps).  Emits one JSON line per (arity, size) build plus
    a proof-batch verify at the largest size per arity."""
    results: List[Dict] = []
    for arity in arities:
        for n in sizes:
            res = bench_merkle_build(n, arity, iters=3)
            results.append(res)
            print(json.dumps(res))
        # dedupe=False: the sweep measures the per-proof path across all
        # seven arities; seven deduped schedules buy nothing at 256 proofs.
        res = bench_batch_verify(proofs, sizes[-1], arity, iters=3, dedupe=False)
        results.append(res)
        print(json.dumps(res))
    return results


def bench_sharded_build(
    n_leaves: int, arity: int, n_devices: int = None, iters: int = 3
) -> Dict:
    """Sharded tree build over the device mesh (the north-star workload:
    leaves sharded, per-level collectives — no reference analog)."""
    import jax
    import jax.numpy as jnp

    from cuzk_tpu.parallel import distributed

    mesh = distributed.make_mesh(n_devices)
    d = mesh.shape[distributed.DATA_AXIS]
    leaves = jnp.asarray(_rand_digits(n_leaves, 17))

    def build(lv):
        return distributed.sharded_merkle_root(lv, arity, mesh)

    st = time_fn_stats(build, leaves, iters=iters, warmup=1, groups=iters)
    sec = st["mean_s"]
    return {
        "suite": "sharded_build",
        "leaves": n_leaves,
        "arity": arity,
        "devices": d,
        "build_ms": round(sec * 1e3, 2),
        "build_ms_p50": round(st["p50_s"] * 1e3, 2),
        "build_ms_min": round(st["min_s"] * 1e3, 2),
        "leaves_per_s": round(n_leaves / sec, 1),
    }


def bench_weak_scaling(
    leaves_per_device: int, arity: int, max_devices: int = None, iters: int = 3
) -> List[Dict]:
    """Weak-scaling sweep: constant leaves PER DEVICE while the mesh grows
    (1, 2, 4, ... devices).  Efficiency = throughput(d) / (d x throughput(1));
    the north-star target is >= 0.80 at 1M leaves, arity 8 (BASELINE.md).

    On a VIRTUAL mesh (xla_force_host_platform_device_count: d logical
    devices sharing one physical host) parallel efficiency necessarily
    decays as ~1/d — the shards execute serialized — so the result also
    records ``efficiency_serialized`` = throughput(d) / throughput(1)
    (ideal 1.0): total-throughput retention, i.e. the OVERHEAD the sharded
    program (collectives + shard_map plumbing) adds over the serialized
    compute.  On real multi-chip hardware read ``efficiency``; on a
    virtual mesh read ``efficiency_serialized``."""
    import jax

    n_avail = len(jax.devices())
    virtual = jax.devices()[0].platform == "cpu" and jax.process_count() == 1
    counts = []
    d = 1
    while d <= (max_devices or n_avail):
        counts.append(d)
        d *= 2
    results = []
    base_tps = None
    for d in counts:
        res = bench_sharded_build(leaves_per_device * d, arity, d, iters=iters)
        res["suite"] = "weak_scaling"
        if base_tps is None:
            base_tps = res["leaves_per_s"]
        res["efficiency"] = round(res["leaves_per_s"] / (d * base_tps), 4)
        if virtual:
            res["efficiency_serialized"] = round(
                res["leaves_per_s"] / base_tps, 4
            )
        results.append(res)
    return results


# Reference poseidon_benchmark configs (benchmark.cpp:213-235).
POSEIDON_CONFIGS = [
    (512, 10_000, "Small Scale"),
    (1024, 100_000, "Medium Scale"),
    (4096, 1_000_000, "Large Scale"),
]


def _print_summary(results: List[Dict]) -> None:
    """Human summary after the JSON lines — the analog of the reference
    binary's speedup tables + best-performer summary (benchmark.cpp:81-123).
    """
    import jax

    if not results:
        return
    rows = []
    best_pairs = None
    for r in results:
        s = r.get("suite")
        if s == "poseidon":
            cfg = f"{r['mode']} batch={r['batch']}"
            if r.get("pipelined"):
                cfg += " (coalesced)"
            rows.append((s, cfg, f"{r['ns_per_hash']} ns/hash",
                         f"{r['hashes_per_s']:,.0f} hash/s",
                         r.get("vs_baseline")))
            if r["mode"] == "pairs" and (
                best_pairs is None or r["hashes_per_s"] > best_pairs[1]
            ):
                best_pairs = (cfg, r["hashes_per_s"])
        elif s in ("merkle_build", "sharded_build", "weak_scaling"):
            cfg = f"{r['leaves']} leaves a={r['arity']}"
            if "devices" in r:
                cfg += f" d={r['devices']}"
            extra = (
                f"eff={r['efficiency']}" if "efficiency" in r
                else f"{r['leaves_per_s']:,.0f} leaves/s"
            )
            rows.append((s, cfg, f"{r['build_ms']} ms", extra,
                         r.get("vs_baseline")))
        elif s == "batch_verify":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['verify_ms']} ms",
                         f"{r['proofs_per_s']:,.0f} proofs/s",
                         r.get("vs_baseline")))
        elif s == "benchmark_tree":
            cfg = f"{r['leaf_count']} leaves a={r['arity']} h={r['tree_height']}"
            rows.append((s, cfg, f"{r['build_time_ms']} ms build",
                         f"+{r['proof_time_ms']} ms gen +{r['verify_time_ms']} ms verify",
                         None))
        elif s == "proof_generation":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['gen_ms']} ms",
                         f"{r['proofs_per_s']:,.0f} proofs/s", None))
        elif s == "batch_verify_resident":
            cfg = f"{r['proofs']} proofs a={r['arity']}"
            rows.append((s, cfg, f"{r['device_ms']} ms device",
                         f"+{r['schedule_ms']} ms host +{r['upload_ms']} ms H2D",
                         r.get("vs_baseline_device")))
        elif s == "merkle_compare":
            cfg = f"{r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['accelerated_ms']} ms",
                         f"{r['speedup']}x vs jnp path",
                         "consistent" if r["trees_consistent"] else "MISMATCH"))
        elif s == "incremental_update":
            cfg = f"{r['updates']} of {r['leaves']} leaves a={r['arity']}"
            rows.append((s, cfg, f"{r['update_ms']} ms",
                         f"{r['speedup_vs_rebuild']}x vs rebuild",
                         "consistent" if r["roots_consistent"] else "MISMATCH"))
    if not rows:
        return
    dev = jax.devices()[0]
    print(f"\n== Summary ({jax.default_backend()}, {dev.device_kind}) ==")
    widths = [max(len(str(row[i])) for row in rows + [
        ("suite", "config", "time", "throughput", "vs baseline")
    ]) for i in range(5)]
    hdr = ("suite", "config", "time", "throughput", "vs baseline")
    print("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for row in rows:
        vsb = row[4]
        vs = (f"{vsb}x" if isinstance(vsb, (int, float)) else (vsb or "-"))
        cells = [str(row[0]), str(row[1]), str(row[2]), str(row[3]), vs]
        print("  ".join(c.ljust(w) for c, w in zip(cells, widths)))
    if best_pairs is not None:
        print(
            f"Best pair-hash throughput: {best_pairs[1]:,.0f} hash/s"
            f" ({best_pairs[0]})"
        )


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--suite",
        default="all",
        choices=[
            "all", "poseidon", "merkle", "proofs", "trees", "scaling",
            "sweep", "compare", "updates",
        ],
    )
    parser.add_argument("--devices", type=int, default=None)
    parser.add_argument("--path", default="kernel", choices=["kernel", "jnp"])
    parser.add_argument("--mode", default="both", choices=["both", "pairs", "single"])
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--total", type=int, default=None)
    parser.add_argument("--leaves", type=int, default=50_000)
    parser.add_argument("--arity", type=int, default=4)
    parser.add_argument("--proofs", type=int, default=5_000)
    parser.add_argument(
        "--weak",
        action="store_true",
        help="scaling suite: weak-scaling sweep (--leaves = leaves PER device)",
    )
    parser.add_argument("--skip-verify", action="store_true")
    pipe = parser.add_mutually_exclusive_group()
    pipe.add_argument(
        "--pipeline", action="store_true",
        help="poseidon suite: force the coalescing engine for every config",
    )
    pipe.add_argument(
        "--sync", action="store_true",
        help="poseidon suite: chip-capability rows — device-resident "
        "operands, batch loop on device, slope-timed (hop-free)",
    )
    parser.add_argument(
        "--no-dedupe",
        action="store_true",
        help="proofs suite: force the per-proof verify path (no dedup schedule)",
    )
    parser.add_argument(
        "--device-resident",
        action="store_true",
        help="proofs suite: also run the phase-decomposed resident benchmark"
        " (schedule/upload/device phases timed separately)",
    )
    parser.add_argument(
        "--tampered",
        action="store_true",
        help="proofs suite: also run the failure-isolation benchmark"
        " (one tampered proof in an otherwise valid batch)",
    )
    args = parser.parse_args()

    results: List[Dict] = []
    from cuzk_tpu.utils.device import require_gpu

    require_gpu()
    # The gate covers every suite that runs accelerated ops (the reference
    # gates its whole benchmark binary, benchmark.cpp:137-144): the merkle
    # and proofs suites run entirely on hash_multiple, which the widened
    # gate now checks.
    if not args.skip_verify and args.suite in (
        "all", "poseidon", "merkle", "proofs", "sweep", "compare", "updates"
    ):
        ok = verify_paths_match()
        print(json.dumps({"suite": "verify_paths_match", "ok": ok}))
        if not ok:
            raise SystemExit("jnp and kernel paths disagree; aborting benchmarks")

    if args.suite in ("all", "poseidon"):
        modes = ["pairs", "single"] if args.mode == "both" else [args.mode]
        if args.batch:
            configs = [(args.batch, args.total or args.batch * 100, "Custom")]
        else:
            configs = POSEIDON_CONFIGS
        pipeline = True if args.pipeline else (False if args.sync else None)
        for batch, total, label in configs:
            for mode in modes:
                if args.sync:
                    # Chip-capability row: device-resident operands, batch
                    # loop on device, slope-timed (hop-free).
                    res = bench_poseidon_resident(batch, total, mode)
                else:
                    res = bench_poseidon(batch, total, mode, args.path, pipeline)
                res["label"] = label
                results.append(res)
                print(json.dumps(res))

    if args.suite in ("all", "merkle"):
        res = bench_merkle_build(args.leaves, args.arity)
        results.append(res)
        print(json.dumps(res))

    if args.suite in ("all", "proofs"):
        res = bench_proof_generation(args.proofs, args.leaves, args.arity)
        results.append(res)
        print(json.dumps(res))
        res = bench_batch_verify(
            args.proofs, args.leaves, args.arity,
            dedupe=False if args.no_dedupe else None,
        )
        results.append(res)
        print(json.dumps(res))
        if args.device_resident:
            res = bench_batch_verify_resident(
                args.proofs, args.leaves, args.arity
            )
            results.append(res)
            print(json.dumps(res))
        if args.tampered:
            res = bench_batch_verify_tampered(
                args.proofs, args.leaves, args.arity
            )
            results.append(res)
            print(json.dumps(res))

    if args.suite == "trees":
        results.extend(bench_tree_matrix())

    if args.suite == "compare":
        res = bench_merkle_compare(args.leaves, args.arity)
        results.append(res)
        print(json.dumps(res))
        if not res["trees_consistent"]:
            raise SystemExit("compare: reference and accelerated trees differ")

    if args.suite == "updates":
        res = bench_incremental_update(args.leaves, args.arity)
        results.append(res)
        print(json.dumps(res))
        if not res["roots_consistent"]:
            raise SystemExit("updates: incremental and rebuilt roots differ")

    if args.suite == "sweep":
        results.extend(bench_merkle_sweep())

    if args.suite == "scaling":
        if args.weak:
            for res in bench_weak_scaling(
                args.leaves, args.arity, args.devices
            ):
                results.append(res)
                print(json.dumps(res))
        else:
            res = bench_sharded_build(args.leaves, args.arity, args.devices)
            results.append(res)
            print(json.dumps(res))

    _print_summary(results)


if __name__ == "__main__":
    main()
