"""Presence-interval algebra over sorted first/last_observed stamp vectors.

Equivalent of the reference's khronos_attribute_utils presence helpers
(khronos/include/khronos/utils/khronos_attribute_utils.h:46-106):
an object's presence is a union of closed intervals
[first_observed[i], last_observed[i]], both vectors sorted ascending.

Stamps are int64 nanoseconds throughout.

Unchanged host copy of `khronos_tpu/utils/intervals.py`.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple


def is_present(first: Sequence[int], last: Sequence[int], t: int) -> bool:
    """True iff t lies inside any presence interval."""
    i = bisect.bisect_right(first, t) - 1
    return i >= 0 and t <= last[i]


def has_appeared(first: Sequence[int], t: int) -> bool:
    """True iff the object has appeared at or before t (any interval started)."""
    return len(first) > 0 and first[0] <= t


def has_disappeared(first: Sequence[int], last: Sequence[int], t: int) -> bool:
    """True iff the object has (permanently, as known) disappeared by t:
    t is past the end of some interval and not inside a later one."""
    if not last:
        return False
    return not is_present(first, last, t) and last[0] < t


def add_presence_duration(
    first: List[int], last: List[int], t_from: int, t_until: int
) -> Tuple[List[int], List[int]]:
    """Union the interval [t_from, t_until] into the sorted interval set.

    Mirrors khronos_attribute_utils `addPresenceDuration`: overlapping/touching
    intervals are merged; returns new sorted vectors.
    """
    if t_until < t_from:
        raise ValueError(f"invalid interval [{t_from}, {t_until}]")
    intervals = sorted(list(zip(first, last)) + [(t_from, t_until)])
    merged: List[Tuple[int, int]] = []
    for f, l in intervals:
        if merged and f <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], l))
        else:
            merged.append((f, l))
    out_f = [f for f, _ in merged]
    out_l = [l for _, l in merged]
    return out_f, out_l


def clamp_intervals(
    first: Sequence[int], last: Sequence[int], t_min: int, t_max: int
) -> Tuple[List[int], List[int]]:
    """Intersect the interval set with [t_min, t_max], dropping empties."""
    out_f, out_l = [], []
    for f, l in zip(first, last):
        f2, l2 = max(f, t_min), min(l, t_max)
        if f2 <= l2:
            out_f.append(f2)
            out_l.append(l2)
    return out_f, out_l


def merge_presence(
    first_a: Sequence[int],
    last_a: Sequence[int],
    first_b: Sequence[int],
    last_b: Sequence[int],
) -> Tuple[List[int], List[int]]:
    """Union of two interval sets (used when merging reconciled objects)."""
    out_f, out_l = list(first_a), list(last_a)
    for f, l in zip(first_b, last_b):
        out_f, out_l = add_presence_duration(out_f, out_l, f, l)
    return out_f, out_l


def first_seen(first: Sequence[int]) -> int:
    return first[0] if len(first) else -1


def last_seen(last: Sequence[int]) -> int:
    return last[-1] if len(last) else -1
