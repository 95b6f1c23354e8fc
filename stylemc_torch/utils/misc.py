"""Small shared helpers (counterpart of `stylemc_tpu/utils/misc.py`)."""

from __future__ import annotations

import re
from typing import List, Sequence, Tuple


def num_range(s: str) -> List[int]:
    """'a-c' or 'a,b,c' → list of ints."""
    m = re.match(r"^(\d+)-(\d+)$", s)
    if m:
        return list(range(int(m.group(1)), int(m.group(2)) + 1))
    return [int(x) for x in s.split(",")]


def assert_shape(x, ref_shape: Sequence):
    """Shape assertion with None wildcards."""
    assert len(x.shape) == len(ref_shape), \
        f"rank mismatch: {x.shape} vs {ref_shape}"
    for dim, (got, want) in enumerate(zip(x.shape, ref_shape)):
        if want is not None and got != want:
            raise AssertionError(f"dim {dim}: {got} != {want} ({x.shape})")


def unravel_index(index: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """A flat index → its coordinates in a row-major array of `shape`."""
    out = []
    for dim in reversed(shape):
        out.append(index % dim)
        index //= dim
    return tuple(reversed(out))
