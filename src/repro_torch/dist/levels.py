"""Level schedule for the multi-level distributed sort (DESIGN.md §8).

A copy of ``repro.dist.levels`` (pure Python; the port imports nothing of
``repro``).  AMS-sort runs the paper's sample -> classify -> partition ->
exchange recursion once per *level of the machine hierarchy*; this module
flattens the *mesh* recursion into an explicit, statically planned
schedule:

  axes = ("pod", "data")   ->   [ Level(axis="pod",  groups=p0, ...),
                                  Level(axis="data", groups=p1, ...) ]

Level l collapses mesh axis ``axes[l]``: ranks sharing the leading axis
coordinates ``axes[:l]`` form a *group* that owns one contiguous key range
and is itself distributed over ``domain = axes[l:]``.  The exchange at
level l is an ``all_to_all_single`` over ``axes[l]`` only (fan-in = that
axis size, not the world size), against a splitter set of ``groups - 1``
values.  After the last level every rank owns a contiguous global range
and sorts locally.

Capacities are *expectation-based*: the balanced data volume entering any
level is ~``n_local`` per rank, so each per-(sender, group) chunk gets
``ceil(n_local / groups) * slack`` slots (rounded up to 128); ``slack`` is
headroom over the balanced expectation, learned per (n_local, d, dtype)
by the ``dist:`` plan family (``ops/plan.py``).

**Topology-aware ordering** (DESIGN.md §13.4): the per-level collective
cost differs per mesh axis.  On GPUs, an axis inside a node runs over
NVLink and an axis across nodes over the network, several times slower.
:func:`order_axes` reorders the level schedule to minimise a static cost
model (:func:`schedule_cost`) with two terms per level:

  * the ``all_to_all`` wire term: ``(groups - 1)/groups`` of the padded
    frame crosses the axis, divided by that axis's bandwidth.  Under
    expectation-based capacities it is order-*invariant*, so it anchors
    the model but does not drive the ordering;
  * the splitter/control term: level l's sample ``all_gather`` (and the
    re-split ``all_reduce``s) span the whole remaining domain ``axes[l:]``
    and are bottlenecked by the *slowest* axis in it.  Slow axes therefore
    schedule first, and the highest-fan-in exchange runs late, over a
    domain holding only the fastest links.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Optional, Tuple, Union

from repro_torch.core import sampling

__all__ = [
    "Level",
    "plan_schedule",
    "normalize_axes",
    "default_oversample",
    "axis_bandwidths",
    "schedule_cost",
    "order_axes",
]

AxisNames = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Level:
    """One flattened step of the mesh recursion (one exchanged axis)."""

    axis: str                  # mesh axis collapsed by this level's all_to_all
    domain: Tuple[str, ...]    # axes[l:]: the group this level's splitters span
    groups: int                # size of ``axis`` = buckets = collective fan-in
    n_in: int                  # padded per-shard element count entering the level
    capacity: int              # per-(sender, group) chunk slots in the exchange
    oversample: int            # per-shard sample size for this level's splitters

    @property
    def n_out(self) -> int:
        """Padded per-shard element count after this level's exchange."""
        return self.groups * self.capacity


def normalize_axes(axes: AxisNames) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def default_oversample(n_total: int) -> int:
    """Per-shard sample size: the paper's alpha scaled for the distributed
    setting (splitters must be good enough that no retry is the common
    case)."""
    return max(32, sampling.oversampling_factor(n_total) * 16)


def _round_up(x: int, unit: int = 128) -> int:
    return -(-x // unit) * unit


def plan_schedule(
    axis_sizes: Mapping[str, int],
    axes: AxisNames,
    n_local: int,
    *,
    slack: float = 2.0,
    oversample: int = 0,
) -> Tuple[Level, ...]:
    """The explicit level loop for ``axes`` (outermost first).

    ``axis_sizes`` maps mesh axis name -> size (``dict(mesh.shape)``).
    ``oversample=0`` uses :func:`default_oversample`.  Capacities round up
    to 128 lanes and never drop below one lane register, mirroring the
    single-level seed formula so the compat shim is shape-identical.
    """
    names = normalize_axes(axes)
    if not names:
        raise ValueError("at least one mesh axis is required")
    sizes = [int(axis_sizes[a]) for a in names]
    d_total = 1
    for s in sizes:
        d_total *= s
    if oversample <= 0:
        oversample = default_oversample(n_local * d_total)
    levels = []
    n = n_local
    for lvl, (name, g) in enumerate(zip(names, sizes)):
        # headroom over the *balanced* per-pair expectation n_local / g;
        # the padded size entering deeper levels stays ~slack * n_local
        cap = _round_up(max(128, int(-(-n_local * slack // g))))
        levels.append(
            Level(
                axis=name,
                domain=tuple(names[lvl:]),
                groups=g,
                n_in=n,
                capacity=cap,
                oversample=oversample,
            )
        )
        n = g * cap
    return tuple(levels)


def axis_bandwidths(axis_sizes: Mapping[str, int]) -> dict:
    """Default relative collective bandwidth per mesh axis.

    Mesh axes are conventionally declared outermost-first: the slowest
    interconnect (the network between nodes) outermost, the fastest
    (NVLink between the GPUs of a node) innermost, so the default assigns
    each axis ``4**position`` in declaration order.  Pass an explicit
    mapping to :func:`order_axes` / :func:`schedule_cost` when the machine
    differs; only ratios matter.

    >>> axis_bandwidths({"pod": 2, "data": 4})
    {'pod': 1.0, 'data': 4.0}
    """
    return {a: 4.0 ** i for i, a in enumerate(axis_sizes)}


def schedule_cost(
    schedule: Tuple[Level, ...],
    bandwidths: Mapping[str, float],
    itemsize: int = 4,
) -> float:
    """Static per-level collective cost of a schedule (relative units).

    Extends ``benchmarks/sort_distributed.py``'s volume accounting with
    bandwidth weights: per level, the ``all_to_all`` moves
    ``(groups - 1) * capacity * itemsize`` bytes off-shard over the
    level's axis, and the splitter/control collectives gather
    ``oversample * itemsize`` bytes from every *other* shard of the
    remaining domain, bottlenecked by the slowest axis still in it.

    >>> sched = plan_schedule({"pod": 2, "data": 4}, ("pod", "data"), 8192)
    >>> swapped = plan_schedule({"pod": 2, "data": 4}, ("data", "pod"), 8192)
    >>> bw = axis_bandwidths({"pod": 2, "data": 4})
    >>> schedule_cost(sched, bw) < schedule_cost(swapped, bw)  # slow axis first
    True
    """
    total = 0.0
    domain_size = {}
    acc = 1
    for lv in reversed(schedule):
        acc *= lv.groups
        domain_size[lv.axis] = acc
    for lv in schedule:
        wire = (lv.groups - 1) * lv.capacity * itemsize
        total += wire / bandwidths.get(lv.axis, 1.0)
        dsz = domain_size[lv.axis]
        min_bw = min(bandwidths.get(a, 1.0) for a in lv.domain)
        total += lv.oversample * itemsize * (dsz - 1) / min_bw
    return total


def order_axes(
    axis_sizes: Mapping[str, int],
    axes: AxisNames,
    n_local: int,
    *,
    bandwidths: Optional[Mapping[str, float]] = None,
    slack: float = 2.0,
    oversample: int = 0,
) -> Tuple[str, ...]:
    """The axis order minimising :func:`schedule_cost` (ties keep the
    caller's order).  Axis counts are tiny, so plain permutation
    enumeration; the result feeds :func:`plan_schedule` and is persisted
    as the ``dist:`` plan's ``axis_order`` dimension (``ops/plan.py``).

    >>> order_axes({"pod": 2, "data": 4}, ("data", "pod"), 8192)
    ('pod', 'data')
    >>> order_axes({"pod": 2, "data": 4}, ("data", "pod"), 8192,
    ...            bandwidths={"pod": 4.0, "data": 1.0})
    ('data', 'pod')
    """
    names = normalize_axes(axes)
    if len(names) < 2:
        return names
    bw = dict(bandwidths) if bandwidths is not None else axis_bandwidths(axis_sizes)
    best, best_cost = names, None
    # permutations() emits the caller's order first, and only a strictly
    # cheaper permutation displaces it — ties keep the given order
    for perm in itertools.permutations(names):
        sched = plan_schedule(
            axis_sizes, perm, n_local, slack=slack, oversample=oversample
        )
        cost = schedule_cost(sched, bw)
        if best_cost is None or cost < best_cost - 1e-9:
            best, best_cost = perm, cost
    return tuple(best)
