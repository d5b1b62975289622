"""Device introspection (the analog of print_device_info /
check_cuda_compatibility — field_arithmetic_cuda.cu:629-650,
merkle_tree_cuda.cu:603-621).

:func:`on_gpu` is the one platform check the library makes: on a GPU the
hash paths run the CUDA kernel and Merkle level loops fuse into one jitted
program; anywhere else (the CPU) they run the plain jnp reference with
host-driven level loops.
"""

from __future__ import annotations

from typing import Dict, List


def device_info() -> List[Dict]:
    """One dict per visible device."""
    import jax

    out = []
    for d in jax.devices():
        out.append(
            {
                "id": d.id,
                "platform": d.platform,
                "device_kind": d.device_kind,
                "process_index": d.process_index,
            }
        )
    return out


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU (decided at trace time)."""
    import jax

    return jax.default_backend() == "gpu"


def check_gpu_compatibility() -> bool:
    """True if a GPU is visible; mirrors the reference's boolean pre-flight
    (merkle_tree_cuda.cu:603-621).  Without one the library still runs,
    on the CPU through the jnp reference path."""
    import jax

    try:
        return any(d.platform == "gpu" for d in jax.devices())
    except RuntimeError:
        return False


def require_gpu() -> None:
    """Raise SystemExit unless the first JAX device is a GPU — measurement
    entry points call this so a number is never taken on the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} ({dev.device_kind})"
        )
