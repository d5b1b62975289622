"""Test configuration: the CPU backend with 8 virtual devices.

Mirrors the reference's hardware-gating strategy (SURVEY.md §4): correctness
never depends on a GPU.  Sharding tests run on a virtual 8-device CPU mesh;
GPU performance is measured by bench.py and chip_smoke.py, not the suite.

Tests that need the GPU carry the ``gpu`` marker and skip here.  With
``CUZK_TEST_GPU=1`` the suite leaves JAX's platform alone, so on a machine
with a GPU ``CUZK_TEST_GPU=1 python -m pytest tests/ -m gpu -n 0`` runs
them (one process: each JAX process reserves most of the card's memory).

Must run before jax is imported anywhere.
"""

import os
import sys

_ON_GPU_RUN = os.environ.get("CUZK_TEST_GPU") == "1"
if not _ON_GPU_RUN:
    # Force (not setdefault): correctness tests run on the virtual 8-device
    # CPU mesh even where the environment presets another platform.
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
# NOTE: do NOT add --xla_backend_optimization_level=0 — on the dot-based
# field programs O0 is ~5x SLOWER to compile than the default pipeline
# (441 s vs 90 s for one sponge bucket: unoptimized scalarized IR explodes
# before instruction selection).
os.environ["XLA_FLAGS"] = _flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent XLA compilation cache: recompiling the fused permutation on every
# pytest invocation wastes minutes; cached executables load in milliseconds.
from cuzk_tpu.utils.compilecache import enable_compile_cache  # noqa: E402

_cache_dir = enable_compile_cache()

import gc

# JAX tracing allocates millions of short-lived objects; under pytest's
# large live-object population the default GC thresholds make every trace
# trigger frequent full collections (measured ~15x compile slowdowns).
# Raise the gen0 threshold and freeze the startup heap.
gc.freeze()
gc.set_threshold(200_000, 100, 100)

import jax  # noqa: E402

if not _ON_GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
if os.environ.get("CUZK_NO_COMPILE_CACHE") != "1":
    jax.config.update("jax_compilation_cache_dir", _cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
# NOTE: do NOT enable jax_persistent_cache_enable_xla_caches='all' — the
# CPU-backend AOT serialization it forces makes every compile ~10x slower.


import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's backend is a GPU
    (decided here, at run time, never while collecting)."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: CUZK_TEST_GPU=1 python -m pytest -m gpu -n 0")


@pytest.fixture(autouse=True, scope="module")
def _bound_process_memory():
    """Drop JAX's in-memory executable caches when RSS grows past ~16 GB.

    A cold-cache full-suite run accumulates tens of GB of compile state in
    one process; past ~30 GB RSS the persistent-cache write path segfaults
    natively (observed in jax's put_executable_and_time under zstandard).
    Clearing is NOT free — reloading a big sponge executable from the
    persistent cache costs 20-60 s (zstd + AOT deserialize, docs/PERF.md) —
    so only clear when actually approaching the danger zone."""
    yield
    with open("/proc/self/statm") as f:
        rss_bytes = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    if rss_bytes > 16 << 30:
        import jax

        jax.clear_caches()


# ---------------------------------------------------------------------------
# Run every test in a fresh worker thread.
#
# JAX tracing cost scales with Python stack DEPTH (per-primitive bookkeeping
# walks live frames); pytest adds ~40 frames, which measured as a ~12x
# slowdown on our 100K-primitive traces.  A worker thread starts at depth ~2,
# restoring plain-python compile times.
# ---------------------------------------------------------------------------

import threading


def pytest_pyfunc_call(pyfuncitem):
    testfunction = pyfuncitem.obj
    kwargs = {
        name: pyfuncitem.funcargs[name]
        for name in pyfuncitem._fixtureinfo.argnames
    }
    outcome = {}

    def run():
        try:
            testfunction(**kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised in main thread
            outcome["exc"] = e

    t = threading.Thread(target=run, name="cuzk-test-runner")
    t.start()
    t.join()
    if "exc" in outcome:
        raise outcome["exc"]
    return True
