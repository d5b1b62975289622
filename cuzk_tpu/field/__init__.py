"""BN254-Fr field layer: exact oracle semantics on 16-bit digits."""

from cuzk_tpu.field import fr
from cuzk_tpu.field.fr import (
    NDIGITS,
    DIGIT_BITS,
    add,
    sub,
    mul,
    square,
    power5,
    mul_small,
    red,
    eq,
    is_zero,
    int_to_digits,
    digits_to_int,
    ints_to_array,
    array_to_ints,
)

__all__ = [
    "fr",
    "NDIGITS",
    "DIGIT_BITS",
    "add",
    "sub",
    "mul",
    "square",
    "power5",
    "mul_small",
    "red",
    "eq",
    "is_zero",
    "int_to_digits",
    "digits_to_int",
    "ints_to_array",
    "array_to_ints",
]
