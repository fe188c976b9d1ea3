# Copied from src/repro/core/padding.py (numpy only); keep the two in step.
"""The one home for every padding rule in the index/serving stack.

Three spellings used to live in three modules (``_pad_to`` / ``_pow2``
in device_engine, ``pad_pow2`` in dist_engine, re-imported by the
serving scheduler); they are consolidated here so the shape contracts
the planner warms up, the batcher buckets by, and the build/refresh
stages pad to can never drift apart.

Contracts (property-tested in tests/test_padding.py):

  * ``pad_to(x, mult)``   — smallest multiple of ``mult`` that is
    >= max(x, mult); used for fragment/boundary axis padding (device
    tiles want multiples of 8, not powers of two).
  * ``pow2(x, floor)``    — smallest power-of-two-multiple-of-``floor``
    >= max(x, floor) (``floor`` itself need not be a power of two);
    used for batch-count padding so jitted programs compile for
    O(log n) distinct shapes.
  * ``pad_pow2(n, floor)`` — alias of ``pow2`` with the query-planner
    default floor of 16: the padded bucket sizes every serve
    sub-program is warmup-compiled at.

All three are monotone non-decreasing, idempotent (f(f(x)) == f(x)),
and never smaller than their input — the properties batching and
warmup correctness lean on.
"""
from __future__ import annotations


def pad_to(x: int, mult: int = 8) -> int:
    """Round ``x`` up to a multiple of ``mult`` (never below ``mult``)."""
    return max(mult, -(-x // mult) * mult)


def pow2(x: int, floor: int = 1) -> int:
    """Round ``x`` up to ``floor * 2**k`` (never below ``floor``)."""
    m = floor
    while m < x:
        m *= 2
    return m


def pad_pow2(n: int, floor: int = 16) -> int:
    """The query planner's padded bucket size for a batch of ``n``."""
    return pow2(n, floor)
