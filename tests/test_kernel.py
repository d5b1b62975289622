"""The CUDA Poseidon kernel: its arithmetic on the CPU, its wrapper, its
build, and the GPU-only entry points' refusal to run anywhere else.

The kernel (native/poseidon_cuda.cu) has no CPU mode, so its field and
permutation code lives in native/poseidon_fr.h, which g++ compiles here
(native/poseidon_fr_test.cpp) for a differential check against the Python
oracle in every reduction regime.  The Python wrapper around the FFI call
(ops/poseidon_kernel.py) is checked with the kernel swapped for a stand-in.
"""

import ctypes
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

from cuzk_tpu import native, oracle
from cuzk_tpu.field import fr
from cuzk_tpu.ops import poseidon_kernel as pk
from cuzk_tpu.utils import compilecache

rng = random.Random(20240601)
TOP = (1 << 256) - 1
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_U32P = ctypes.POINTER(ctypes.c_uint32)


def _digits(x: int) -> np.ndarray:
    return np.ascontiguousarray(fr.int_to_digits(x))


def _call(name: str, *ints, prefix=()) -> int:
    """Call a poseidon_fr_test.cpp function on digit buffers."""
    bufs = [_digits(x) for x in ints]
    out = np.zeros(fr.NDIGITS, np.uint32)
    getattr(native.load_fr_test(), name)(
        *prefix, *(b.ctypes.data_as(_U32P) for b in bufs), out.ctypes.data_as(_U32P)
    )
    return fr.digits_to_int(out)


def _high(a: int, b: int) -> int:
    return (a * b) >> 256


def _mh(a: int, b: int) -> int:
    return (_high(a, b) * oracle.K) >> 256


# Operand pairs per regime of the truncated k-fold reduction
# (SURVEY.md Appendix A): the product's high half zero; high nonzero but
# high*k below 2^256 (mh == 0, hc left unreduced); mh != 0 (the dropped
# (mh*k) >> 256 term); and values at the top of the 256-bit range, where
# the wrapping adds wrap.
_REGIMES = {
    "high_zero": lambda g: (g.randrange(1 << 128), g.randrange(1 << 128)),
    "small_high": lambda g: (g.randrange(2, 17), g.randrange(1 << 255, 1 << 256)),
    "large_high": lambda g: (g.randrange(oracle.P), g.randrange(oracle.P)),
    "wrap": lambda g: (TOP - g.randrange(1 << 64), TOP - g.randrange(1 << 64)),
}


@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_fr_header_mul_regimes(regime):
    g = random.Random(regime)
    pairs = [_REGIMES[regime](g) for _ in range(200)]
    if regime == "high_zero":
        assert all(_high(a, b) == 0 for a, b in pairs)
    elif regime == "small_high":
        assert all(_high(a, b) and not _mh(a, b) for a, b in pairs)
    elif regime == "large_high":
        pairs = [(a, b) for a, b in pairs if _mh(a, b)]
        assert len(pairs) > 150
    for a, b in pairs:
        assert _call("fr_mul", a, b) == oracle.mul(a, b), (regime, a, b)
        assert _call("fr_add", a, b) == oracle.add(a, b), (regime, a, b)


def test_fr_header_red_and_add_edges():
    for x in [0, 1, oracle.P - 1, oracle.P, 2 * oracle.P, 5 * oracle.P, TOP]:
        assert _call("fr_red", x) == oracle.red(x)
        assert _call("fr_add", x, TOP) == oracle.add(x, TOP)
        assert _call("fr_power5", x) == oracle.power5(x)


def test_fr_header_mul_small_matches_mul():
    xs = [rng.randrange(1 << 256) for _ in range(64)] + [0, oracle.P - 1, TOP]
    cs = sorted(set(oracle.MDS)) + [0, 1, (1 << 64) - 1, rng.randrange(1 << 64)]
    for c in cs:
        for x in xs:
            assert _call("fr_mul_small", x, prefix=(c,)) == oracle.mul(c, x)


def test_fr_header_round_constants():
    got = [_call("fr_round_constant", prefix=(i,)) for i in range(len(oracle.RC))]
    assert got == oracle.RC
    # The kernel receives the Python table; it must encode the same limbs.
    words = pk.RC_WORDS.astype(np.uint64)
    limbs = words[:, 0::2] | (words[:, 1::2] << np.uint64(32))
    assert [
        sum(int(v) << (64 * i) for i, v in enumerate(row)) for row in limbs
    ] == oracle.RC


def test_fr_header_permutation_golden_and_unreduced():
    states = [[1, 2, 3], [TOP, oracle.P, oracle.P - 1], [TOP - oracle.RC[1], 0, TOP]]
    states += [[rng.randrange(1 << 256) for _ in range(3)] for _ in range(4)]
    for st in states:
        buf = np.concatenate([_digits(x) for x in st])
        native.load_fr_test().fr_permutation(buf.ctypes.data_as(_U32P))
        got = [fr.digits_to_int(buf[16 * i : 16 * i + 16]) for i in range(3)]
        assert got == oracle.permutation(st)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 8, 9])
def test_fr_header_sponge_goldens(n):
    lib = native.load_fr_test()
    for ds in (1, 2, 3):
        xs = [rng.randrange(1 << 256) for _ in range(n)]
        buf = np.ascontiguousarray(
            np.concatenate([_digits(x) for x in xs]) if xs else np.zeros(16, np.uint32)
        )
        out = np.zeros(16, np.uint32)
        lib.fr_sponge(buf.ctypes.data_as(_U32P), n, ds, out.ctypes.data_as(_U32P))
        assert fr.digits_to_int(out) == oracle.sponge(xs, ds)
    if n == 2:
        assert _sponge_pair(10, 20) == int(
            "0x2dd359f92d31c747e06c02b360a9f5c761777b285edcf09724efef5cbd51d9ba", 16
        )


def _sponge_pair(a: int, b: int) -> int:
    buf = np.concatenate([_digits(a), _digits(b)])
    out = np.zeros(16, np.uint32)
    native.load_fr_test().fr_sponge(buf.ctypes.data_as(_U32P), 2, 2, out.ctypes.data_as(_U32P))
    return fr.digits_to_int(out)


def test_fr_header_noncanonical_digits():
    """Digits >= 2^16 enter as sum(d_i * 2^(16 i)) mod 2^256, the value the
    jnp path's first wrapping add sees."""
    d = np.array([0xFFFF_FFFF] * 16, np.uint32)
    val = sum(int(v) << (16 * i) for i, v in enumerate(d.tolist())) % (1 << 256)
    out = np.zeros(16, np.uint32)
    zero = np.zeros(16, np.uint32)
    native.load_fr_test().fr_add(d.ctypes.data_as(_U32P), zero.ctypes.data_as(_U32P),
                                 out.ctypes.data_as(_U32P))
    assert fr.digits_to_int(out) == oracle.add(val, 0)


# ---------------------------------------------------------------------------
# The FFI wrapper: bucketing, padding, slicing, and the choice of kernel.
# ---------------------------------------------------------------------------


def test_bucket_policy():
    assert [pk._bucket(b) for b in (1, 127, 128, 129, 4096, 5000)] == [
        128, 128, 128, 256, 4096, 8192,
    ]


@pytest.fixture
def fake_gpu(monkeypatch):
    """Pretend the backend is a GPU, with the CUDA calls replaced by a
    cheap stand-in that records what reaches them and, like the kernel,
    leaves rows past ``active`` unwritten (here: 0xDEAD)."""
    import jax.numpy as jnp

    calls = []

    def fake_sponge(x, active, ds):
        calls.append(("sponge", x.shape, ds))
        w = jnp.arange(1, x.shape[1] + 1, dtype=jnp.uint32)[None, :, None]
        h = (jnp.sum(x * w, axis=1) + ds) & 0xFFFF
        rows = jnp.arange(x.shape[0])[:, None] < active[0]
        return jnp.where(rows, h, 0xDEAD).astype(jnp.uint32)

    def fake_perm(st, active):
        calls.append(("perm", st.shape))
        rows = jnp.arange(st.shape[0])[:, None, None] < active[0]
        return jnp.where(rows, st ^ 1, 0xDEAD).astype(jnp.uint32)

    monkeypatch.setattr(pk, "on_gpu", lambda: True)
    monkeypatch.setattr(pk, "_sponge_kernel", fake_sponge)
    monkeypatch.setattr(pk, "_permutation_kernel", fake_perm)
    import jax

    jax.clear_caches()  # the chains must retrace with the stand-ins
    yield calls
    jax.clear_caches()


@pytest.mark.parametrize("b", [1, 5, 128, 130])
def test_kernel_wrapper_pads_and_slices(fake_gpu, b):
    from cuzk_tpu import ops

    x = np.random.default_rng(b).integers(0, 1 << 16, (b, 3, 16), np.uint32)
    bp = pk._bucket(b)
    w = np.arange(1, 4, dtype=np.uint32)[None, :, None]

    got = np.asarray(ops.hash_multiple_pallas(x))
    assert got.shape == (b, 16)
    np.testing.assert_array_equal(got, ((x * w).sum(axis=1) + 3) & 0xFFFF)
    assert fake_gpu[-1] == ("sponge", (bp, 3, 16), oracle.DS_MULTIPLE)

    got = np.asarray(ops.hash_pair_pallas(x[:, 0], x[:, 1]))
    np.testing.assert_array_equal(
        got, (x[:, 0] + 2 * x[:, 1] + oracle.DS_PAIR) & 0xFFFF
    )
    assert fake_gpu[-1] == ("sponge", (bp, 2, 16), oracle.DS_PAIR)

    got = np.asarray(ops.permutation_pallas(x))
    np.testing.assert_array_equal(got, x ^ 1)
    assert fake_gpu[-1] == ("perm", (bp, 3, 16))


def test_kernel_choice_cpu_never_loads_library(monkeypatch):
    """Off the GPU the accelerated API runs the jnp reference and never
    touches the CUDA library."""
    from cuzk_tpu import ops

    def refuse():
        raise AssertionError("CUDA library touched on the CPU")

    monkeypatch.setattr(pk, "_register_kernels", refuse)
    l, r = fr.ints_to_array([10]), fr.ints_to_array([20])
    assert fr.array_to_ints(ops.hash_pair_pallas(l, r))[0] == oracle.hash_pair(10, 20)


@pytest.fixture
def unbuilt_kernel(monkeypatch, tmp_path):
    """A GPU backend whose kernel library is not built yet."""
    monkeypatch.setattr(pk, "on_gpu", lambda: True)
    monkeypatch.setattr(pk, "_registered", False)
    monkeypatch.setattr(native, "_CUDA_LIB", str(tmp_path / "libmissing.so"))
    return tmp_path


def test_missing_nvcc_on_gpu_raises(unbuilt_kernel, monkeypatch):
    from cuzk_tpu import ops

    monkeypatch.setattr(native, "nvcc_path", lambda: str(unbuilt_kernel / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ops.hash_pair_pallas(fr.ints_to_array([1]), fr.ints_to_array([2]))


def test_failed_kernel_build_on_gpu_raises(unbuilt_kernel, monkeypatch):
    from cuzk_tpu import ops

    fake = unbuilt_kernel / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: sm_90a not supported' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "nvcc_path", lambda: str(fake))
    with pytest.raises(RuntimeError, match="sm_90a not supported"):
        ops.permutation_pallas(np.zeros((1, 3, 16), np.uint32))
    assert not os.path.exists(native._CUDA_LIB)


# ---------------------------------------------------------------------------
# The compile cache's path rules.
# ---------------------------------------------------------------------------


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilecache.enable_compile_cache() == str(tmp_path)
    assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(tmp_path)


def test_compile_cache_default_is_gitignored_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compilecache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---------------------------------------------------------------------------
# GPU-only entry points refuse to run elsewhere.
# ---------------------------------------------------------------------------


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _prints_result(stdout: str) -> bool:
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return json.loads(lines[-1]).get("ok") is True
    except (ValueError, AttributeError):
        return False


def test_chip_smoke_exits_nonzero_on_cpu():
    proc = _run_smoke(REPO, {"PYTHONPATH": REPO})
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)
    assert "no GPU" in proc.stderr


def test_chip_smoke_exits_nonzero_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)


# ---------------------------------------------------------------------------
# On the GPU: the kernel itself against the C++ oracle.
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_kernel_matches_native_oracle_gpu():
    from cuzk_tpu import ops

    g = np.random.default_rng(3)
    l = g.integers(0, 1 << 16, (1000, 16), np.uint32)
    r = g.integers(0, 1 << 16, (1000, 16), np.uint32)
    l[0], r[0] = _digits(TOP), _digits(oracle.P)
    np.testing.assert_array_equal(
        np.asarray(ops.hash_pair_pallas(l, r)), native.batch_hash_pairs_digits(l, r)
    )
    for w in (1, 4, 8, 9, 33):
        x = g.integers(0, 1 << 16, (300, w, 16), np.uint32)
        np.testing.assert_array_equal(
            np.asarray(ops.hash_multiple_pallas(x)),
            native.batch_hash_multiple_digits(x),
        )
    st = g.integers(0, 1 << 16, (500, 3, 16), np.uint32)
    np.testing.assert_array_equal(
        np.asarray(ops.permutation_pallas(st)), native.batch_permutation_digits(st)
    )
