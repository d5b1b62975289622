"""Native (C++ / CUDA) components of cuzk_tpu.

- ``oracle.cpp``: an independent 4x64-limb implementation of the exact
  reference semantics, compiled on demand with g++ and loaded via ctypes —
  a fast third implementation for differential testing (Python-int oracle
  <-> jnp/kernel paths <-> C++) and for golden vectors at scale.
- ``scheduler.cpp``: exact row grouping for the dedup verify schedule.
- ``poseidon_fr.h``: the GPU kernel's field and permutation code, shared by
  ``poseidon_cuda.cu`` (nvcc, the Hopper kernel) and ``poseidon_fr_test.cpp``
  (g++, so the CPU tests check the kernel's arithmetic).

Every library builds into ``_build/`` at first use (or when a source is
newer), through a temporary file that is renamed into place, so concurrent
builders never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oracle.cpp")
_BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "liboraclecpp.so")

_lib: Optional[ctypes.CDLL] = None

_MASK64 = (1 << 64) - 1


def _build(cmd: List[str], out: str, sources: Sequence[str], force: bool) -> str:
    """Run ``cmd + ["-o", tmp]`` and rename ``tmp`` onto ``out`` when ``out``
    is missing or older than any of ``sources``.  Raises RuntimeError with
    the compiler's output on failure."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if (
        not force
        and os.path.exists(out)
        and os.path.getmtime(out) >= max(os.path.getmtime(s) for s in sources)
    ):
        return out
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run(
            cmd + ["-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {os.path.basename(out)} failed "
                f"({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def ensure_built(force: bool = False) -> str:
    """Compile the oracle library if missing/stale; returns its path."""
    return _build(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC],
        _LIB, [_SRC], force,
    )


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        u64p = ctypes.POINTER(ctypes.c_uint64)
        for name, argtypes in {
            "cuzk_add": [u64p, u64p, u64p],
            "cuzk_sub": [u64p, u64p, u64p],
            "cuzk_mul": [u64p, u64p, u64p],
            "cuzk_red": [u64p, u64p],
            "cuzk_power5": [u64p, u64p],
            "cuzk_permutation": [u64p],
            "cuzk_hash_single": [u64p, u64p],
            "cuzk_hash_pair": [u64p, u64p, u64p],
            "cuzk_hash_multiple": [u64p, ctypes.c_size_t, u64p],
            "cuzk_batch_hash_pairs": [u64p, u64p, u64p, ctypes.c_size_t],
            "cuzk_batch_hash_single": [u64p, u64p, ctypes.c_size_t],
            "cuzk_batch_hash_multiple": [
                u64p, ctypes.c_size_t, ctypes.c_size_t, u64p
            ],
            "cuzk_batch_permutation": [u64p, ctypes.c_size_t],
            "cuzk_merkle_root": [u64p, ctypes.c_size_t, ctypes.c_size_t, u64p],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _lib = lib
    return _lib


def _to_limbs(x: int) -> List[int]:
    return [(x >> (64 * i)) & _MASK64 for i in range(4)]


def _from_limbs(limbs: Sequence[int]) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(limbs))


def _buf(ints: Sequence[int]) -> "ctypes.Array":
    flat: List[int] = []
    for x in ints:
        flat.extend(_to_limbs(x))
    return (ctypes.c_uint64 * len(flat))(*flat)


def _out(n_elems: int) -> "ctypes.Array":
    return (ctypes.c_uint64 * (4 * n_elems))()


def _read(buf, n_elems: int) -> List[int]:
    return [_from_limbs(buf[4 * i : 4 * i + 4]) for i in range(n_elems)]


# ---------------------------------------------------------------------------
# Int-level convenience wrappers (mirror cuzk_tpu.oracle's API)
# ---------------------------------------------------------------------------

def add(a: int, b: int) -> int:
    o = _out(1)
    load().cuzk_add(_buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def sub(a: int, b: int) -> int:
    o = _out(1)
    load().cuzk_sub(_buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def mul(a: int, b: int) -> int:
    o = _out(1)
    load().cuzk_mul(_buf([a]), _buf([b]), o)
    return _read(o, 1)[0]


def red(a: int) -> int:
    o = _out(1)
    load().cuzk_red(_buf([a]), o)
    return _read(o, 1)[0]


def power5(a: int) -> int:
    o = _out(1)
    load().cuzk_power5(_buf([a]), o)
    return _read(o, 1)[0]


def permutation(state: Sequence[int]) -> List[int]:
    buf = _buf(list(state))
    load().cuzk_permutation(buf)
    return _read(buf, 3)


def hash_single(x: int) -> int:
    o = _out(1)
    load().cuzk_hash_single(_buf([x]), o)
    return _read(o, 1)[0]


def hash_pair(l: int, r: int) -> int:
    o = _out(1)
    load().cuzk_hash_pair(_buf([l]), _buf([r]), o)
    return _read(o, 1)[0]


def hash_multiple(inputs: Sequence[int]) -> int:
    o = _out(1)
    load().cuzk_hash_multiple(_buf(list(inputs)), len(inputs), o)
    return _read(o, 1)[0]


def batch_hash_pairs(ls: Sequence[int], rs: Sequence[int]) -> List[int]:
    n = len(ls)
    o = _out(n)
    load().cuzk_batch_hash_pairs(_buf(list(ls)), _buf(list(rs)), o, n)
    return _read(o, n)


def merkle_root(leaves: Sequence[int], arity: int) -> int:
    o = _out(1)
    load().cuzk_merkle_root(_buf(list(leaves)), len(leaves), arity, o)
    return _read(o, 1)[0]


# ---------------------------------------------------------------------------
# Digit-array wrappers: ``[..., 16]`` uint32 canonical 16-bit digits in and
# out (cuzk_tpu.field.fr's format), converted to limbs with numpy — large
# batches without a Python int per element.
# ---------------------------------------------------------------------------


def _limbs(digits):
    import numpy as np

    d = np.ascontiguousarray(digits, np.uint64)
    limbs = d[..., 0::4] | (d[..., 1::4] << 16) | (d[..., 2::4] << 32) | (
        d[..., 3::4] << 48
    )
    return np.ascontiguousarray(limbs, np.uint64)


def _digits(limbs):
    import numpy as np

    shifts = np.arange(4, dtype=np.uint64) * np.uint64(16)
    d = (limbs[..., :, None] >> shifts) & np.uint64(0xFFFF)
    return d.reshape(limbs.shape[:-1] + (16,)).astype(np.uint32)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def batch_hash_pairs_digits(left, right):
    """``[n, 16]`` x2 -> ``[n, 16]`` pair hashes."""
    import numpy as np

    l, r = _limbs(left), _limbs(right)
    out = np.empty_like(l)
    load().cuzk_batch_hash_pairs(_ptr(l), _ptr(r), _ptr(out), l.shape[0])
    return _digits(out)


def batch_hash_multiple_digits(inputs):
    """``[n, w, 16]`` -> ``[n, 16]`` hash_multiple of each row."""
    import numpy as np

    x = _limbs(inputs)
    n, w = x.shape[0], x.shape[1]
    out = np.empty((n, 4), np.uint64)
    load().cuzk_batch_hash_multiple(_ptr(x), n, w, _ptr(out))
    return _digits(out)


def batch_permutation_digits(states):
    """``[n, 3, 16]`` -> ``[n, 3, 16]`` raw permutations."""
    s = _limbs(states)
    load().cuzk_batch_permutation(_ptr(s), s.shape[0])
    return _digits(s)


def merkle_root_digits(leaves, arity: int):
    """Root ``[16]`` of ``[n, 16]`` leaves."""
    import numpy as np

    x = _limbs(leaves)
    out = np.empty((1, 4), np.uint64)
    load().cuzk_merkle_root(_ptr(x), x.shape[0], arity, _ptr(out))
    return _digits(out)[0]


# ---------------------------------------------------------------------------
# The GPU kernel's shared header, compiled for the host (poseidon_fr_test.cpp)
# so its arithmetic is testable without a GPU.
# ---------------------------------------------------------------------------

_FR_HDR = os.path.join(_DIR, "poseidon_fr.h")
_FR_TEST_SRC = os.path.join(_DIR, "poseidon_fr_test.cpp")
_FR_TEST_LIB = os.path.join(_BUILD_DIR, "libposeidon_fr_test.so")
_fr_test_lib = None


def load_fr_test() -> ctypes.CDLL:
    """The host build of poseidon_fr.h (g++), loaded via ctypes."""
    global _fr_test_lib
    if _fr_test_lib is None:
        path = _build(
            ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _FR_TEST_SRC],
            _FR_TEST_LIB, [_FR_TEST_SRC, _FR_HDR], False,
        )
        lib = ctypes.CDLL(path)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        for name, argtypes in {
            "fr_add": [u32p, u32p, u32p],
            "fr_mul": [u32p, u32p, u32p],
            "fr_mul_small": [ctypes.c_ulonglong, u32p, u32p],
            "fr_red": [u32p, u32p],
            "fr_power5": [u32p, u32p],
            "fr_round_constant": [ctypes.c_int, u32p],
            "fr_permutation": [u32p],
            "fr_sponge": [u32p, ctypes.c_int, ctypes.c_ulonglong, u32p],
        }.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = None
        _fr_test_lib = lib
    return _fr_test_lib


# ---------------------------------------------------------------------------
# The CUDA kernel library (poseidon_cuda.cu), built with nvcc for sm_90a.
# ---------------------------------------------------------------------------

_CUDA_SRC = os.path.join(_DIR, "poseidon_cuda.cu")
_CUDA_LIB = os.path.join(_BUILD_DIR, "libcuzk_poseidon_cuda.so")


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, else the PATH, else the
    toolkit's default install prefix."""
    import shutil

    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def ensure_cuda_built(force: bool = False) -> str:
    """Compile the CUDA kernel library if missing/stale; returns its path.
    Raises RuntimeError when nvcc is missing or the build fails."""
    import jax.ffi

    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (looked for {nvcc}); the GPU Poseidon kernel "
            "cannot be built"
        )
    return _build(
        [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-I", jax.ffi.include_dir(), "-I", _DIR, _CUDA_SRC,
        ],
        _CUDA_LIB, [_CUDA_SRC, _FR_HDR], force,
    )


# ---------------------------------------------------------------------------
# Native exact-grouping scheduler (scheduler.cpp): the hot host primitives
# of the dedup verify schedule — byte-exact row/triple partitioning via a
# hash table that compares full contents on every probe (no trusted
# hashes, no confirmation pass).  cuzk_tpu.merkle uses these when
# available and falls back to the numpy bucket-and-confirm path otherwise.
# ---------------------------------------------------------------------------

_SCHED_SRC = os.path.join(_DIR, "scheduler.cpp")
_SCHED_LIB = os.path.join(_BUILD_DIR, "libcuzkscheduler.so")

_sched_lib = None


def ensure_scheduler_built(force: bool = False) -> str:
    """Compile the scheduler library if missing/stale; returns its path."""
    return _build(
        ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SCHED_SRC],
        _SCHED_LIB, [_SCHED_SRC], force,
    )


def load_scheduler() -> ctypes.CDLL:
    global _sched_lib
    if _sched_lib is None:
        lib = ctypes.CDLL(ensure_scheduler_built())
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        lib.cuzk_group_rows.argtypes = [u8p, i64, i64, i64, i32p, i32p]
        lib.cuzk_group_rows.restype = i64
        lib.cuzk_group_triples.argtypes = [i32p, i32p, i32p, i64, i32p, i32p]
        lib.cuzk_group_triples.restype = i64
        _sched_lib = lib
    return _sched_lib


def scheduler_available() -> bool:
    try:
        load_scheduler()
        return True
    except Exception:
        return False


def group_rows(rows):
    """Exact byte-equality partition of ``rows`` (``[k, w]`` numpy array;
    last axis contiguous, row width a multiple of 8 bytes — every proof
    row shape satisfies both).  Returns ``(first, inv)`` int32 arrays:
    first-occurrence row index per group, group id per row."""
    import numpy as np

    k = int(rows.shape[0])
    wbytes = int(rows.shape[1]) * rows.itemsize
    if rows.strides[1] != rows.itemsize or wbytes % 8 or rows.strides[0] <= 0:
        raise ValueError("rows must have a contiguous 8-byte-multiple row")
    first = np.empty(k, np.int32)
    inv = np.empty(k, np.int32)
    lib = load_scheduler()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u = lib.cuzk_group_rows(
        ctypes.cast(rows.ctypes.data, u8p), k, int(rows.strides[0]), wbytes,
        first.ctypes.data_as(i32p), inv.ctypes.data_as(i32p),
    )
    return first[:u].copy(), inv


def group_triples(a, b, c):
    """Exact partition of ``(a[i], b[i], c[i])`` int32 triples (the suffix
    key: parent-suffix group, sibling-row group, position).  Same outputs
    as :func:`group_rows`; no bit-width limits on the components."""
    import numpy as np

    a = np.ascontiguousarray(a, np.int32)
    b = np.ascontiguousarray(b, np.int32)
    c = np.ascontiguousarray(c, np.int32)
    k = int(a.shape[0])
    first = np.empty(k, np.int32)
    inv = np.empty(k, np.int32)
    lib = load_scheduler()
    i32p = ctypes.POINTER(ctypes.c_int32)
    u = lib.cuzk_group_triples(
        a.ctypes.data_as(i32p), b.ctypes.data_as(i32p),
        c.ctypes.data_as(i32p), k,
        first.ctypes.data_as(i32p), inv.ctypes.data_as(i32p),
    )
    return first[:u].copy(), inv
