"""Cross-cutting utilities (the L0 analog of src/common + the I/O and stats
helpers scattered through the reference)."""

from cuzk_tpu.utils.io import (
    to_hex,
    from_hex,
    to_decimal,
    from_decimal,
    random_element,
    random_elements,
)
from cuzk_tpu.utils.errors import (
    ValidationError,
    ComputationError,
    IndexError_,
    validate_range,
    validate_index,
    validate_non_empty,
)
from cuzk_tpu.utils.stats import HashingStats, TreeBenchmarkResult, timed
from cuzk_tpu.utils.device import device_info, check_gpu_compatibility

__all__ = [
    "to_hex",
    "from_hex",
    "to_decimal",
    "from_decimal",
    "random_element",
    "random_elements",
    "ValidationError",
    "ComputationError",
    "IndexError_",
    "validate_range",
    "validate_index",
    "validate_non_empty",
    "HashingStats",
    "TreeBenchmarkResult",
    "timed",
    "device_info",
    "check_gpu_compatibility",
]
