"""Semiring algebra for sparse operations (port of ``combblas_tpu/semiring.py``).

A semiring is a small frozen dataclass whose additive operation is one of the
three reduction kinds ``sum | min | max`` and whose multiplicative operation
is one of five named elementwise functions.  Unlike the JAX package, ``mul``
is named rather than an arbitrary callable: the CUDA kernels take the integer
codes :data:`ADD_CODES` / :data:`MUL_CODES` as launch arguments, so every
semiring the registry holds runs through the same compiled kernels.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "Semiring",
    "ADD_CODES",
    "MUL_CODES",
    "PLUS_TIMES",
    "MIN_PLUS",
    "MAX_PLUS",
    "MAX_TIMES",
    "OR_AND",
    "MAX_SECOND",
    "MIN_SECOND",
    "MAX_FIRST",
    "get_semiring",
]

#: Integer code of each add kind, as the CUDA kernels take it.
ADD_CODES = {"sum": 0, "min": 1, "max": 2}
#: Integer code of each multiplicative operation, as the CUDA kernels take it.
MUL_CODES = {"times": 0, "plus": 1, "second": 2, "first": 3, "and": 4}


def _add_identity(add_kind: str, dtype: torch.dtype) -> torch.Tensor:
    """Additive identity of ``add_kind`` for ``dtype`` as a 0-d tensor."""
    if add_kind == "sum":
        return torch.zeros((), dtype=dtype)
    if add_kind == "min":
        if dtype.is_floating_point:
            return torch.tensor(float("inf"), dtype=dtype)
        return torch.tensor(torch.iinfo(dtype).max, dtype=dtype)
    if add_kind == "max":
        if dtype.is_floating_point:
            return torch.tensor(float("-inf"), dtype=dtype)
        if dtype == torch.bool:
            return torch.zeros((), dtype=dtype)
        return torch.tensor(torch.iinfo(dtype).min, dtype=dtype)
    raise ValueError(f"unknown add_kind {add_kind!r}")


def _mul(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if kind == "times":
        return a * b
    if kind == "plus":
        return a + b
    if kind == "second":
        return b
    if kind == "first":
        return a
    # and: (a != 0 & b != 0) in the operands' common type
    return ((a != 0) & (b != 0)).to(torch.result_type(a, b))


@dataclasses.dataclass(frozen=True)
class Semiring:
    """An algebraic semiring ``(add, mul, 0)``.

    ``add_kind`` is one of ``sum | min | max``; ``mul_kind`` one of
    ``times | plus | second | first | and``.
    """

    name: str
    add_kind: str
    mul_kind: str

    def __post_init__(self):
        if self.add_kind not in ADD_CODES:
            raise ValueError(f"add_kind must be sum|min|max, got {self.add_kind}")
        if self.mul_kind not in MUL_CODES:
            raise ValueError(f"unknown mul_kind {self.mul_kind!r}")

    @property
    def add_code(self) -> int:
        return ADD_CODES[self.add_kind]

    @property
    def mul_code(self) -> int:
        return MUL_CODES[self.mul_kind]

    def zero(self, dtype: torch.dtype) -> torch.Tensor:
        """Additive identity for ``dtype`` (used as the padding value)."""
        return _add_identity(self.add_kind, dtype)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.add_kind == "sum":
            return a + b
        if self.add_kind == "min":
            return torch.minimum(a, b)
        return torch.maximum(a, b)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return _mul(self.mul_kind, a, b)


#: Arithmetic (+, *): the default ring.
PLUS_TIMES = Semiring("plus_times", "sum", "times")
#: Tropical (min, +): shortest paths.
MIN_PLUS = Semiring("min_plus", "min", "plus")
#: (max, +): critical paths.
MAX_PLUS = Semiring("max_plus", "max", "plus")
#: (max, *): approximate-weight matching.
MAX_TIMES = Semiring("max_times", "max", "times")
#: Boolean (or, and): structural products.
OR_AND = Semiring("or_and", "max", "and")
#: (max, select2nd): BFS frontier expansion.
MAX_SECOND = Semiring("max_second", "max", "second")
#: (min, select2nd): FastSV grandparent propagation.
MIN_SECOND = Semiring("min_second", "min", "second")
#: (max, select1st): masked selection.
MAX_FIRST = Semiring("max_first", "max", "first")

_REGISTRY = {
    sr.name: sr
    for sr in (
        PLUS_TIMES,
        MIN_PLUS,
        MAX_PLUS,
        MAX_TIMES,
        OR_AND,
        MAX_SECOND,
        MIN_SECOND,
        MAX_FIRST,
    )
}


def get_semiring(name: str) -> Semiring:
    """Look up a registered semiring by name."""
    return _REGISTRY[name]
