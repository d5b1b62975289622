"""Batched field-op API — parity with ``CudaFieldArithmetic``'s batch surface
(cuda/field_arithmetic_cuda.cuh:25-81: batch_add/subtract/multiply/square/
power5 over element arrays).

These are simply the jitted vectorized ops from
:mod:`cuzk_tpu.field.fr` — XLA owns buffers, so the reference's per-call
malloc/H2D/D2H pipeline (field_arithmetic_cuda.cu:362-432) has no analog.
Provided as an explicit class for API discoverability and stats parity.
"""

from __future__ import annotations

from cuzk_tpu.field import fr
from cuzk_tpu.utils.stats import HashingStats, timed


class BatchFieldArithmetic:
    """CudaFieldArithmetic analog: stateless batch ops + timing stats."""

    def __init__(self):
        self.stats = HashingStats()

    @staticmethod
    def initialize() -> bool:
        """No device setup needed (the reference probes and configures the
        CUDA device here, field_arithmetic_cuda.cu:316-353)."""
        return True

    @staticmethod
    def cleanup() -> None:
        return None

    def _timed(self, f, *args):
        out, sec = timed(f, *args)
        self.stats.total_hashes += int(out.shape[0]) if out.ndim else 1
        self.stats.total_time_s += sec
        return out

    def batch_add(self, a, b):
        return self._timed(fr.add, a, b)

    def batch_subtract(self, a, b):
        return self._timed(fr.sub, a, b)

    def batch_multiply(self, a, b):
        return self._timed(fr.mul, a, b)

    def batch_square(self, a):
        return self._timed(fr.square, a)

    def batch_power5(self, a):
        return self._timed(fr.power5, a)

    def batch_reduce(self, a):
        return self._timed(fr.red, a)
