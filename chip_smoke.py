"""Smoke test of the main path on one GPU: hash, tree build, prove, verify.

Drives the library through its public entry points (``cuzk_tpu.ops``,
``engine.CoalescingPoseidonEngine``, ``merkle.NaryMerkleTree``,
``merkle.verify_all``/``verify_each``/``verify_proofs``) at real sizes,
with every hash on the GPU going through the CUDA kernel, and checks each
result bit-exactly against the C++ oracle (``cuzk_tpu.native``), the
Python-int oracle, or the plain jnp path run on the same card:

  (a) kernel vs C++ oracle: 65,536 pair hashes of full 256-bit inputs
      (0, p-1, p and 2^256-1 among them), hash_multiple at widths 1-9, 16
      and 33, the raw permutation on unreduced states;
  (b) the reference's hash configs: 1,048,576 pair hashes at batch 4096,
      and a stream of batch-512 calls through the coalescing engine;
  (c) Filecoin's 512 MiB-sector tree shape: 2^24 64-byte leaves, arity 8,
      built by NaryMerkleTree; root equal to the jnp path's; 64 proofs
      checked by the Python oracle; fused and host-driven builds equal;
  (d) the reference's 50K-leaf arity-4 tree: root vs the C++ oracle, 5,000
      proofs through verify_all (dedup) and verify_proofs, one tampered
      proof caught by verify_each, 64 leaf updates equal to a rebuild;
  (e) kernel vs XLA's plain jnp path: pair hashes at batch 4096 and 65,536,
      and a 2^20-leaf arity-8 build (hash_multiple at width 8).

``--four-cards`` runs only the sharded path instead: sharded_build_levels
and sharded_generate_proofs of the 2^24-leaf arity-8 tree on a 1-D mesh of
four GPUs, compared with the single-card root and proofs.

Exits non-zero, printing no result, without a GPU or if any phase fails.
The last line of a passing run is one JSON object naming the device.

Usage:  python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from cuzk_tpu.utils.compilecache import enable_compile_cache

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cuzk_tpu import engine, merkle, native, oracle, poseidon  # noqa: E402
from cuzk_tpu import ops  # noqa: E402
from cuzk_tpu.field import fr  # noqa: E402

SPECIALS = (0, oracle.P - 1, oracle.P, (1 << 256) - 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def rand_digits(key, shape) -> np.ndarray:
    """Random canonical 16-bit digits (full 256-bit values), made on the
    device and fetched."""
    return np.array(jax.random.bits(key, shape, jnp.uint32) & 0xFFFF)


def parallel_native(fn, *arrays, chunks: int = 16) -> np.ndarray:
    """Run a row-wise native oracle call over row chunks in threads (the
    ctypes calls release the GIL)."""
    parts = [np.array_split(a, chunks) for a in arrays]
    with ThreadPoolExecutor(chunks) as pool:
        outs = list(pool.map(lambda i: fn(*(p[i] for p in parts)), range(chunks)))
    return np.concatenate(outs, axis=0)


def median_time(fn, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` after one warm-up call, each
    call ended by ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"    ok: {what}")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_a(key, n_pairs: int = 65536, rows: int = 512, n_states: int = 4096):
    k1, k2, k3, k4 = jax.random.split(key, 4)
    l = rand_digits(k1, (n_pairs, fr.NDIGITS))
    r = rand_digits(k2, (n_pairs, fr.NDIGITS))
    for i, (a, b) in enumerate(
        [(x, y) for x in SPECIALS for y in SPECIALS]
    ):
        l[i], r[i] = fr.int_to_digits(a), fr.int_to_digits(b)
    got = np.asarray(ops.hash_pair_pallas(l, r))
    want = parallel_native(native.batch_hash_pairs_digits, l, r)
    check(np.array_equal(got, want), f"{n_pairs} pair hashes == C++ oracle")

    got = np.asarray(ops.hash_pair_pallas_loop(l[:rows], r[:rows], 3))
    want = l[:rows]
    for _ in range(3):
        want = native.batch_hash_pairs_digits(want, r[:rows])
    check(np.array_equal(got, want), f"device loop: 3 chained pair hashes x{rows} == C++ oracle")

    for w in list(range(1, 10)) + [16, 33]:
        x = rand_digits(jax.random.fold_in(k3, w), (rows, w, fr.NDIGITS))
        x[0] = fr.int_to_digits((1 << 256) - 1)
        x[1] = fr.int_to_digits(oracle.P)
        got = np.asarray(ops.hash_multiple_pallas(x))
        want = parallel_native(native.batch_hash_multiple_digits, x)
        check(np.array_equal(got, want), f"hash_multiple width {w} x{rows} == C++ oracle")

    st = rand_digits(k4, (n_states, 3, fr.NDIGITS))
    st[0] = fr.ints_to_array([(1 << 256) - 1, oracle.P, oracle.P - 1])
    st[1] = fr.ints_to_array([(1 << 256) - 1 - oracle.RC[1], 0, 1 << 255])
    got = np.asarray(ops.permutation_pallas(st))
    want = parallel_native(native.batch_permutation_digits, st)
    check(np.array_equal(got, want), f"{n_states} raw permutations of unreduced states == C++ oracle")


def phase_b(key, total: int = 1_048_576, batch: int = 4096,
            stream_calls: int = 2048, stream_batch: int = 512):
    k1, k2, k3 = jax.random.split(key, 3)
    n_calls = total // batch
    lefts = jax.random.bits(k1, (n_calls, batch, fr.NDIGITS), jnp.uint32) & 0xFFFF
    rights = jax.random.bits(k2, (n_calls, batch, fr.NDIGITS), jnp.uint32) & 0xFFFF
    jax.block_until_ready(ops.hash_pair_pallas(lefts[0], rights[0]))
    t0 = time.perf_counter()
    outs = [ops.hash_pair_pallas(lefts[i], rights[i]) for i in range(n_calls)]
    jax.block_until_ready(outs)
    sec = time.perf_counter() - t0
    log(f"    {n_calls * batch} pair hashes at batch {batch}: {sec:.4f} s "
        f"({n_calls * batch / sec:.6g} hashes/s)")
    sample = [0, n_calls // 2, n_calls - 1]
    for i in sample:
        want = parallel_native(
            native.batch_hash_pairs_digits,
            np.asarray(lefts[i]), np.asarray(rights[i]),
        )
        check(np.array_equal(np.asarray(outs[i]), want), f"batch-4096 call {i} == C++ oracle")

    eng = engine.CoalescingPoseidonEngine()
    l_h = rand_digits(k3, (stream_calls, stream_batch, fr.NDIGITS))
    r_h = l_h[::-1].copy()
    t0 = time.perf_counter()
    handles = [eng.async_hash_pairs(l_h[i], r_h[i]) for i in range(stream_calls)]
    eng.flush()
    results = [h.get() for h in handles]
    jax.block_until_ready(results)
    sec = time.perf_counter() - t0
    n = stream_calls * stream_batch
    log(f"    {stream_calls} coalesced batch-{stream_batch} calls: {sec:.4f} s "
        f"({n / sec:.6g} hashes/s, {eng.stats.batch_count} flushes)")
    for i in (0, stream_calls // 3, stream_calls - 1):
        want = native.batch_hash_pairs_digits(l_h[i], r_h[i])
        check(np.array_equal(np.asarray(results[i]), want), f"coalesced call {i} == C++ oracle")


def jnp_levels_chunked(level: jnp.ndarray, arity: int, chunk: int = 1 << 17):
    """All levels through the plain jnp path (poseidon.hash_multiple), in
    bounded-size chunks so the reference's intermediates fit the card."""
    levels = [level]
    while level.shape[0] > 1:
        groups = level.reshape(-1, arity, fr.NDIGITS)
        level = jnp.concatenate(
            [poseidon.hash_multiple(groups[i : i + chunk])
             for i in range(0, groups.shape[0], chunk)],
            axis=0,
        )
        levels.append(level)
    return levels


def phase_c(key, log2_leaves: int = 24, arity: int = 8, n_proofs: int = 64):
    n = 1 << log2_leaves
    k1, k2 = jax.random.split(key)
    leaves = jax.random.bits(k1, (n, fr.NDIGITS), jnp.uint32) & 0xFFFF
    jax.block_until_ready(leaves)
    log(f"    leaves: {n} x 64 B = {n * 64 / 2**30:.3f} GiB")

    compiled = merkle._build_levels_fused.lower(leaves, arity).compile()
    ma = compiled.memory_analysis()
    log("    fused build memory_analysis: "
        f"argument={ma.argument_size_in_bytes} output={ma.output_size_in_bytes} "
        f"temp={ma.temp_size_in_bytes} alias={ma.alias_size_in_bytes} "
        f"generated_code={ma.generated_code_size_in_bytes} bytes")

    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    jax.block_until_ready(tree.levels)
    t0 = time.perf_counter()
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    jax.block_until_ready(tree.levels)
    sec = time.perf_counter() - t0
    total_bytes = sum(lv.size * 4 for lv in tree.levels)
    log(f"    NaryMerkleTree build (fused): {sec:.4f} s, height "
        f"{tree.get_tree_height()}, all levels {total_bytes / 2**30:.4f} GiB")

    host = merkle._build_levels(leaves, arity)
    check(len(host) == len(tree.levels) and all(
        bool(jnp.array_equal(a, b)) for a, b in zip(host, tree.levels)
    ), "fused and host-driven builds equal at every level")
    del host

    t0 = time.perf_counter()
    ref = jnp_levels_chunked(leaves, arity)
    root_ref = np.asarray(ref[-1][0])
    log(f"    plain jnp build: {time.perf_counter() - t0:.4f} s")
    del ref
    check(np.array_equal(np.asarray(tree.get_root_hash()), root_ref),
          "kernel root == plain jnp root on the card")

    idx = np.asarray(jax.random.randint(k2, (n_proofs,), 0, n))
    pos, sib = tree.generate_batch_proofs(idx)
    pos, sib = np.asarray(pos), np.asarray(sib)
    leaf_rows = np.asarray(leaves[jnp.asarray(idx)])
    root = fr.digits_to_int(np.asarray(tree.get_root_hash()))
    ok = all(
        oracle.verify_proof(
            [int(p) for p in pos[i]],
            [fr.array_to_ints(s) for s in sib[i]],
            fr.digits_to_int(leaf_rows[i]), root, arity,
        )
        for i in range(n_proofs)
    )
    check(ok, f"{n_proofs} random proofs pass oracle.verify_proof")


def phase_d(key, n_leaves: int = 50_000, arity: int = 4, n_proofs: int = 5000,
            n_updates: int = 64):
    k1, k2 = jax.random.split(key)
    leaves = rand_digits(k1, (n_leaves, fr.NDIGITS))
    tree = merkle.NaryMerkleTree(leaves, merkle.MerkleConfig(arity))
    root = np.asarray(tree.get_root_hash())
    check(np.array_equal(root, native.merkle_root_digits(leaves, arity)),
          f"{n_leaves}-leaf arity-{arity} root == C++ oracle")

    idx = np.arange(n_proofs) % n_leaves
    pos, sib = tree.generate_batch_proofs(idx)
    pos, sib = np.asarray(pos), np.asarray(sib)
    proved = leaves[idx]
    t0 = time.perf_counter()
    ok_all = merkle.verify_all(pos, sib, proved, root, arity)
    log(f"    verify_all (dedup, incl. compile): {time.perf_counter() - t0:.4f} s")
    check(ok_all, f"{n_proofs} proofs pass verify_all (dedup path)")
    t0 = time.perf_counter()
    each = np.asarray(merkle.verify_proofs(pos, sib, proved, root, arity))
    log(f"    verify_proofs (incl. compile): {time.perf_counter() - t0:.4f} s")
    check(bool(each.all()), f"{n_proofs} proofs pass verify_proofs")

    bad = proved.copy()
    bad[n_proofs // 2, 0] ^= 1
    res = merkle.verify_each(pos, sib, bad, root, arity)
    check(np.flatnonzero(~res).tolist() == [n_proofs // 2],
          "verify_each flags exactly the tampered proof")

    wire = merkle._dedup_pack(pos, sib, bad, root, arity)
    wargs = (arity, wire.sizes, wire.kb, wire.tb, wire.lm16, jnp.asarray(wire.packed))
    fused = merkle._dedup_verify_fused(*wargs)
    host = merkle._dedup_verify_levels(*wargs)
    check(all(bool(jnp.array_equal(a, b)) for a, b in zip(fused, host)),
          "dedup verify: fused and host-driven flags and masks equal")

    upd = np.asarray(jax.random.choice(k2, n_leaves, (n_updates,), replace=False))
    vals = rand_digits(jax.random.fold_in(k2, 1), (n_updates, fr.NDIGITS))
    idx_j = jnp.asarray(upd, jnp.int32)
    fused = merkle._update_paths_fused(arity, idx_j, jnp.asarray(vals), *tree.levels)
    host = merkle._update_paths(arity, idx_j, jnp.asarray(vals), tree.levels)
    check(all(bool(jnp.array_equal(a, b)) for a, b in zip(fused, host)),
          "incremental update: fused and host-driven levels equal")
    check(tree.update_leaves(upd, vals), f"{n_updates} leaf updates accepted")
    new_leaves = leaves.copy()
    new_leaves[upd] = vals
    rebuilt = merkle.build_tree_levels(new_leaves, arity)
    check(all(bool(jnp.array_equal(a, b)) for a, b in zip(tree.levels, rebuilt)),
          f"{n_updates} incremental updates == full rebuild at every level")

    sets = [leaves[i::4][: n_leaves // 4] for i in range(4)]
    batch = merkle.build_batch_trees(sets, arity)
    check(all(
        np.array_equal(np.asarray(t.get_root_hash()), native.merkle_root_digits(ls, arity))
        for t, ls in zip(batch, sets)
    ), f"build_batch_trees: 4 fused {n_leaves // 4}-leaf trees == C++ oracle roots")


def phase_e(key, gpu_line: str, log2_build: int = 20):
    k1, k2, k3 = jax.random.split(key, 3)
    rows = []
    for b in (4096, 65536):
        l = jax.random.bits(jax.random.fold_in(k1, b), (b, fr.NDIGITS), jnp.uint32) & 0xFFFF
        r = jax.random.bits(jax.random.fold_in(k2, b), (b, fr.NDIGITS), jnp.uint32) & 0xFFFF
        tk = median_time(ops.hash_pair_pallas, l, r)
        tx = median_time(poseidon.hash_pair, l, r, reps=3)
        check(bool(jnp.array_equal(ops.hash_pair_pallas(l, r), poseidon.hash_pair(l, r))),
              f"batch {b}: kernel == plain jnp")
        rows.append((f"hash_pair batch {b}", tk, tx))

    # NaryMerkleTree pads the leaves to the next power of 8 (2^21 for
    # 2^20) with the empty hash; both builds start from that padded level.
    n = 1 << log2_build
    leaves = jax.random.bits(k3, (n, fr.NDIGITS), jnp.uint32) & 0xFFFF
    leaves = merkle.build_tree_levels(leaves, 8)[0]

    def build_kernel(lv):
        return merkle._build_levels_fused(lv, 8)[-1]

    def build_jnp(lv):
        with merkle.engine_path("jnp"):
            return merkle._build_levels(lv, 8)[-1]

    tk = median_time(build_kernel, leaves)
    tx = median_time(build_jnp, leaves, reps=3)
    check(bool(jnp.array_equal(build_kernel(leaves), build_jnp(leaves))),
          f"2^{log2_build}-leaf arity-8 roots: kernel == plain jnp")
    rows.append((f"2^{log2_build}-leaf arity-8 build (hash_multiple w8)", tk, tx))
    for name, tk, tx in rows:
        log(f"    {name}: kernel {tk * 1e3:.4f} ms, plain XLA {tx * 1e3:.4f} ms, "
            f"ratio {tx / tk:.2f}x  [{gpu_line}]")


def phase_four_cards(key, log2_leaves: int = 24, arity: int = 8, n_proofs: int = 256):
    from cuzk_tpu.parallel import distributed

    n = 1 << log2_leaves
    k1, k2 = jax.random.split(key)
    leaves = jax.random.bits(k1, (n, fr.NDIGITS), jnp.uint32) & 0xFFFF
    idx = np.asarray(jax.random.randint(k2, (n_proofs,), 0, n))

    levels = merkle.build_tree_levels(leaves, arity)
    root = np.asarray(levels[-1][0])
    pos1, sib1 = merkle.generate_proofs(levels, arity, idx)
    pos1, sib1 = np.asarray(pos1), np.asarray(sib1)
    del levels

    mesh = distributed.make_mesh(4)
    sharded, replicated = distributed.sharded_build_levels(leaves, arity, mesh)
    jax.block_until_ready(replicated)
    t0 = time.perf_counter()
    sharded, replicated = distributed.sharded_build_levels(leaves, arity, mesh)
    jax.block_until_ready(replicated)
    log(f"    sharded build on 4 GPUs: {time.perf_counter() - t0:.4f} s, "
        f"{len(sharded)} sharded + {len(replicated)} replicated levels")
    check(np.array_equal(np.asarray(replicated[-1][0]), root),
          "4-GPU sharded root == single-card root")
    pos4, sib4 = distributed.sharded_generate_proofs(
        sharded, replicated, arity, idx, mesh
    )
    check(np.array_equal(np.asarray(pos4), pos1)
          and np.array_equal(np.asarray(sib4), sib1),
          f"{n_proofs} sharded proofs (masked psum + all_gather) == single-card proofs")
    check(merkle.verify_all(pos1, sib1, np.asarray(leaves[jnp.asarray(idx)]), root, arity),
          f"{n_proofs} proofs verify against the root")


# ---------------------------------------------------------------------------


def gpu_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0] if out else out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded 2^24-leaf build and proofs on 4 GPUs",
    )
    args = parser.parse_args()

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX's first device is {devices[0].platform}",
              file=sys.stderr)
        return 2
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"need {want} GPUs, JAX sees {len(devices)}", file=sys.stderr)
        return 2

    gpu_line = gpu_name_and_limit()
    log(gpu_line)
    log(f"jax {jax.__version__}: {devices}")
    t0 = time.perf_counter()
    native.load()
    ops.hash_pair_pallas(np.zeros((1, fr.NDIGITS), np.uint32),
                         np.zeros((1, fr.NDIGITS), np.uint32))
    log(f"kernel library built and loaded: {time.perf_counter() - t0:.2f} s")

    key = jax.random.PRNGKey(args.seed)
    if args.four_cards:
        phases = [("four-cards", lambda k: phase_four_cards(k))]
    else:
        phases = [
            ("a", phase_a), ("b", phase_b), ("c", phase_c), ("d", phase_d),
            ("e", lambda k: phase_e(k, gpu_line)),
        ]
    failed = []
    for i, (name, fn) in enumerate(phases):
        log(f"[phase {name}]")
        t0 = time.perf_counter()
        try:
            fn(jax.random.fold_in(key, i))
            status = "passed"
        except Exception:  # noqa: BLE001 — reported, and fails the run
            traceback.print_exc()
            failed.append(name)
            status = "FAILED"
        log(f"[phase {name}] {status} in {time.perf_counter() - t0:.2f} s")
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
