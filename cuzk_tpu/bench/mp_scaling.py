"""CPU rehearsal of the multi-host protocol under REAL ``jax.distributed``.

This harness reuses the bootstrap proven by tests/mp_worker.py to run the
sharded build across N localhost OS processes x ``--devices-per-proc``
CPU devices each: the ``all_gather`` level collapse and the sparse-psum
proof path ride the cross-process collective transport.  Workers are
pinned to the CPU and it is never pointed at a GPU (each JAX process would
reserve most of one card's memory); its rows are protocol costs on the
host, not device numbers.

All processes share the host's cores, so ``efficiency_serialized`` =
throughput(d)/throughput(1) (ideal 1.0, total-throughput retention) is the
meaningful metric; classic parallel ``efficiency`` necessarily decays ~1/d.

Usage (launcher spawns its own workers):
    python -m cuzk_tpu.bench.mp_scaling --leaves-per-device 512 --arity 8 \
        --procs 1 2 4 --devices-per-proc 2 --out mp_scaling.json
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# Worker: one process of the jax.distributed job.
# ---------------------------------------------------------------------------


def worker(argv) -> None:
    (port, nproc, pid, ldc, leaves_per_device, arity, iters) = (
        int(v) for v in argv
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    from cuzk_tpu.utils.compilecache import enable_compile_cache

    enable_compile_cache()

    from cuzk_tpu.parallel import distributed

    distributed.initialize_multiprocess(
        f"localhost:{port}", nproc, pid, local_device_count=ldc
    )

    import jax
    import numpy as np

    from cuzk_tpu.field import fr

    d = nproc * ldc
    assert len(jax.devices()) == d, jax.devices()
    mesh = distributed.make_mesh()

    if nproc > 1:
        # Tiny collective barrier FIRST: establishes the cross-process Gloo
        # context while the workers are seconds apart.  Without it the
        # first collective is the full gather program, and on a 1-core
        # host the compile skew between workers can exceed Gloo's 30 s
        # rendezvous window (observed: GetKeyValue DEADLINE_EXCEEDED).
        tiny = distributed.shard_batch(
            np.zeros((d, fr.NDIGITS), np.uint32), mesh
        )
        np.asarray(
            distributed._gather_fn(mesh, distributed.DATA_AXIS)(tiny)
            .addressable_data(0)
        )

    # Same host value in every process (shard_batch contract).
    rng = np.random.default_rng(17)
    leaves = rng.integers(
        0, 1 << 16, (leaves_per_device * d, fr.NDIGITS), dtype=np.uint32
    )
    # The build pads the leaf count to the next power of arity
    # (merkle_tree.cpp:50-63 semantics), so the HASHED work is m leaves,
    # not the requested d * leaves_per_device: with arity 8 and 512
    # leaves/device, d = 2 builds a 4096-leaf tree — 8x the requested
    # work.  Throughput must count m or the mid-ladder rows are charged
    # for work they did but not credited (exactly the round-4 artifact's
    # mysterious d=2 -> 0.21 "efficiency": it was 2 t1/t2 with t2 a
    # tree 8x bigger).
    from cuzk_tpu import merkle

    m = merkle.padded_leaf_count(leaves_per_device * d, arity)

    def build():
        _, replicated = distributed.sharded_build_levels(leaves, arity, mesh)
        root = replicated[-1][0]
        # Root readback = completion barrier on every process (the gather
        # and upper levels are replicated, so all shards must have fired).
        return np.asarray(root.addressable_data(0))

    build()  # warm-up/compile
    start = time.perf_counter()
    for _ in range(iters):
        root = build()
    sec = (time.perf_counter() - start) / iters

    # ---- Per-stage decomposition (VERDICT r4 item 3): time each phase of
    # the build alone so a row below the efficiency gate carries evidence
    # of WHERE the loss is — collectives/coordination vs the substrate's
    # compute scheduling.  Stages sum to ~build_ms by construction.

    def timed(fn, warm: int = 1):
        for _ in range(warm):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return round((time.perf_counter() - t0) / iters * 1e3, 2)

    stages = {}
    # Pure coordination floor: one tiny cross-device all_gather + readback
    # (d x 64 B — bandwidth-free, measures the collective transport and
    # any cross-process rendezvous cost per collective).
    gat = distributed._gather_fn(mesh, distributed.DATA_AXIS)
    tiny = distributed.shard_batch(np.zeros((d, fr.NDIGITS), np.uint32), mesh)
    stages["barrier_ms"] = timed(
        lambda: np.asarray(gat(tiny).addressable_data(0)[0, 0])
    )
    # Host->devices staging of the PADDED leaves (device_put with the
    # sharding) — the same array the build stages consume below.
    if m > leaves.shape[0]:
        e = np.array(merkle._empty_hash_digits(arity), np.uint32)
        leaves = np.concatenate(
            [leaves, np.broadcast_to(e, (m - leaves.shape[0], fr.NDIGITS))]
        )
    stages["shard_ms"] = timed(
        lambda: np.asarray(
            distributed.shard_batch(leaves, mesh).addressable_data(0)[0, 0]
        )
    )
    leaves_sh = distributed.shard_batch(leaves, mesh)
    level_fn = distributed._local_level_fn(mesh, distributed.DATA_AXIS, arity)

    def local_levels():
        local_m, level = m // d, leaves_sh
        while local_m > 1 and local_m % arity == 0:
            level = level_fn(level)
            local_m //= arity
        return level

    stages["local_levels_ms"] = timed(
        lambda: np.asarray(local_levels().addressable_data(0)[0, 0])
    )
    last_sharded = local_levels()
    # The real (d * tail bytes) gather of the collapsed level.
    stages["gather_ms"] = timed(
        lambda: np.asarray(gat(last_sharded).addressable_data(0)[0, 0])
    )
    gathered = gat(last_sharded)

    def tail():
        g = gathered
        while g.shape[0] > 1:
            g = merkle._engine_hash_multiple(
                g.reshape(g.shape[0] // arity, arity, fr.NDIGITS)
            )
        return np.asarray(g.addressable_data(0)[0, 0])

    stages["replicated_tail_ms"] = timed(tail)

    if pid == 0:
        print(
            "RESULT "
            + json.dumps(
                {
                    "suite": "weak_scaling_mp",
                    "processes": nproc,
                    "devices_per_process": ldc,
                    "devices": d,
                    "leaves": leaves_per_device * d,
                    "padded_leaves": m,
                    "arity": arity,
                    "build_ms": round(sec * 1e3, 2),
                    # Throughput counts the PADDED (actually hashed) tree.
                    "leaves_per_s": round(m / sec, 1),
                    "stages": stages,
                    "root0": int(root[0]),
                }
            ),
            flush=True,
        )


# ---------------------------------------------------------------------------
# Launcher: one jax.distributed job per process count, results aggregated.
# ---------------------------------------------------------------------------


def run_job(
    nproc: int, ldc: int, leaves_per_device: int, arity: int, iters: int,
    timeout_s: int = 1800,
):
    import tempfile

    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    # Each worker writes to its own temp file, NOT a pipe: with pipes, a
    # worker whose (merged) logging exceeds the ~64 KB pipe buffer blocks
    # mid-collective while the launcher sequentially communicate()s with
    # an earlier worker — deadlocking the whole job until the timeout.
    logs = [
        tempfile.NamedTemporaryFile(
            "w+", suffix=f".mp{i}.log", delete=False
        )
        for i in range(nproc)
    ]
    procs = [
        subprocess.Popen(
            [
                sys.executable, "-m", "cuzk_tpu.bench.mp_scaling", "--worker",
                str(port), str(nproc), str(i), str(ldc),
                str(leaves_per_device), str(arity), str(iters),
            ],
            env=env,
            stdout=logs[i],
            stderr=subprocess.STDOUT,
        )
        for i in range(nproc)
    ]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()  # reap — no zombies
        raise
    outs = []
    for f in logs:
        f.flush()
        f.seek(0)
        outs.append(f.read())
        f.close()
        os.unlink(f.name)
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {i} failed:\n{out}")
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT "):
                return json.loads(line[len("RESULT "):])
    raise RuntimeError("no RESULT line from process 0:\n" + "\n".join(outs))


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(sys.argv[2:])
        return
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--leaves-per-device", type=int, default=512)
    ap.add_argument("--arity", type=int, default=8)
    ap.add_argument("--procs", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument(
        "--configs", nargs="+", default=None, metavar="PROCSxDEV",
        help="explicit '<procs>x<devices_per_proc>' pairs (e.g. 2x1 4x2); "
        "overrides --procs/--devices-per-proc (the (1,1) baseline is "
        "always prepended)",
    )
    ap.add_argument(
        "--out", default=None,
        help="write the JSON artifact to this path (overwrites)",
    )
    args = ap.parse_args()

    rows = []
    base_tps = None
    # Single-process single-device reference point first: throughput(1);
    # then the 1-device-per-process ladder (pure cross-process collectives,
    # no intra-process virtual-device scheduling confound — VERDICT r4
    # item 3); then the multi-device-per-process rows.
    if args.configs:
        configs = [(1, 1)] + [
            tuple(int(v) for v in c.split("x")) for c in args.configs
        ]
    else:
        configs = (
            [(1, 1)]
            + [(p, 1) for p in args.procs if p > 1]
            + [(p, args.devices_per_proc) for p in args.procs
               if args.devices_per_proc > 1]
        )
    seen = set()
    for nproc, ldc in configs:
        if (nproc, ldc) in seen:
            continue
        seen.add((nproc, ldc))
        res = run_job(
            nproc, ldc, args.leaves_per_device, args.arity, args.iters
        )
        d = res["devices"]
        if base_tps is None:
            base_tps = res["leaves_per_s"]
        res["efficiency"] = round(res["leaves_per_s"] / (d * base_tps), 4)
        res["efficiency_serialized"] = round(
            res["leaves_per_s"] / base_tps, 4
        )
        res["cross_process"] = nproc > 1
        rows.append(res)
        print(json.dumps(res), flush=True)

    if args.out:
        artifact = {
            "date": time.strftime("%Y-%m-%d"),
            "substrate": (
                f"{os.cpu_count()}-core host; jax.distributed OS "
                "processes (per-row devices_per_process; cross-process "
                "collectives on rows with processes >= 2)"
            ),
            "leaves_per_device": args.leaves_per_device,
            "arity": args.arity,
            "rows": rows,
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
