"""Per-level exchange: sample -> classify -> stable partition -> all_to_all.

Counterpart of ``repro.dist.exchange``: the body of one
:class:`repro_torch.dist.levels.Level`, run by every rank of the level's
domain on its own shard, over ``torch.distributed``.  It is the paper's
single-node pipeline with the mesh axis as the bucket dimension (DESIGN.md
§8):

  1. **sampling**: every rank samples its *valid prefix* at positions drawn
     by :func:`sample_positions` from a ``torch.Generator`` seeded from
     (seed, level, round, rank): history-independent, as the reference's
     ``fold_in`` chain is, so a restored sort draws the same samples.  The
     samples are gathered over the level's domain
     (``all_gather_into_tensor``) and ``groups - 1`` shared splitters
     selected;
  2. **classification**: the two-searchsorted descent with the distributed
     equality-bucket rule (paper §4.4): an element equal to a duplicated
     splitter stripes across the whole span of groups covering that
     splitter run, by a multiplicative hash of its position;
  3. **stable partition** over ``groups + 1`` buckets (the extra bucket
     collects sentinel pads, which never travel): on a CUDA tensor kernel
     K2 (``kernels.level_fused.rank_hist``) ranks the ids and
     ``core.ips4o._scatter`` moves every tensor, as the learned level 1
     does; on a CPU tensor, K2's plain twin;
  4. **exchange**: one capacity-padded ``all_to_all_single`` with equal
     splits over this level's axis only (the axis's own process group),
     one per tensor, plus the count vector on its own
     ``all_to_all_single``; arrivals are re-compacted to a valid prefix by
     :func:`compact_valid` (a 2-bucket partition through K2 again), so the
     next level sees the invariant it started from.

**Re-split rounds** instead of truncate-on-overflow: when some (sender,
group) chunk would exceed its capacity anywhere in the domain, the next
round recomputes the splitters from the observed histogram of a fresh
sample (``sampling.splitters_from_histogram``).  Where the reference
unrolls the rounds statically and selects on the device, the port reads
the all-reduced overflow verdict on the host once per round (one
``all_reduce`` MAX of the largest chunk, then ``.item()``) and stops at the
first round that fits.  Every rank of the domain reads the same reduced
value, so every rank takes the same branch: the rounds stay collective.
A rank that branched alone would wait forever in a collective the others
never enter.  The rounds stay bounded by ``retries``; if every round
overflows, the exchange truncates deterministically and raises the
overflow flag.

**Overlap** (``overlap=True``, DESIGN.md §13): once the destinations are
fixed, the shard is split into two position-halves; half A is
partitioned, packed, and its ``all_to_all_single`` calls issued with
``async_op=True`` before half B's partition starts; their work handles are
waited on only at reassembly.  Arrivals are reassembled sender-major with
A-slots before B-slots and the truncation budget is shared across the
halves, so the result is bit-identical to the synchronous exchange,
truncation included.

**Radix destinations** (``classifier="radix"``, DESIGN.md §9): at round 0
of a level with a power-of-two group count, each element goes to group
``top log2(groups) bits of its code`` with no sampling collective.
Overflow falls to the splitter-based re-split rounds.

Collectives take tensors of the mesh's device: NCCL on the card, or
``gloo`` (which takes CUDA tensors for every collective used here, as
checked on the H100 with torch 2.11).  With ``repro_torch.obs`` enabled,
the exchange records ``dist.resplit_rounds`` (on the domain's first rank,
as the reference records on its lead shard), a ``dist.exchange_overflow``
event with a warning when it truncates, ``dist.collective_bytes`` per rank
and level, and ``dist.overlap_efficiency``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch import obs
from repro_torch.core import sampling
from repro_torch.core.ips4o import _scatter
from repro_torch.dist.levels import Level
from repro_torch.kernels.level_fused import MAX_TILE, rank_hist

__all__ = [
    "Group",
    "compact_valid",
    "exchange_level",
    "group_for",
    "sample_positions",
    "tile_for",
]

Arrays = Dict[str, torch.Tensor]  # "k": encoded keys; every other entry: a payload leaf

_MASK64 = (1 << 64) - 1


def tile_for(n: int, pref: int) -> int:
    """A partition tile that divides ``n``, at most ``pref`` (the
    reference's helper; the port's K2 places any n, so the exchange passes
    the config's tile as it is).

    >>> tile_for(48, 32)
    16
    >>> tile_for(7, 4)
    1
    """
    return max(1, math.gcd(n, pref))


# --------------------------------------------------------------------------
# process groups with the rank order the exchange needs


@dataclasses.dataclass(frozen=True)
class Group:
    """The ranks of one domain (or one mesh axis), in the order the exchange
    addresses them: position i is the i-th rank of the row-major order over
    the domain's axes, in the order given.  ``group`` is None for a
    one-rank domain (no collective runs); ``perm[i]`` is the process-group
    rank at position i, or None where it is i (``new_group`` orders its
    members by global rank, which the chosen axis order may not)."""

    group: Optional[object]
    size: int
    index: int
    perm: Optional[Tuple[int, ...]] = None

    def _to_group_order(self, x: torch.Tensor) -> torch.Tensor:
        if self.perm is None:
            return x
        inv = np.argsort(self.perm)
        return x.view((self.size, -1) + tuple(x.shape[1:]))[
            torch.as_tensor(inv, device=x.device)].reshape(x.shape)

    def _from_group_order(self, x: torch.Tensor) -> torch.Tensor:
        if self.perm is None:
            return x
        return x.view((self.size, -1) + tuple(x.shape[1:]))[
            torch.as_tensor(self.perm, device=x.device)].reshape(x.shape)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size * len(x), ...) : every rank's ``x``, in position order."""
        if self.size == 1:
            return x
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        tdist.all_gather_into_tensor(out, x.contiguous(), group=self.group)
        return self._from_group_order(out)

    def all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """``x`` reduced over the domain by ``op``, in place."""
        if self.size > 1:
            tdist.all_reduce(x, op=op, group=self.group)
        return x

    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """Send chunk i of ``x`` (size equal chunks along dim 0) to position
        i.  Returns (the receive buffer, to be read through
        :meth:`arrivals` once the work handle, None unless ``async_op``,
        was waited on; the handle)."""
        if self.size == 1:
            return x, None
        send = self._to_group_order(x).contiguous()
        recv = torch.empty_like(send)
        work = tdist.all_to_all_single(recv, send, group=self.group, async_op=async_op)
        return recv, work

    def arrivals(self, recv: torch.Tensor) -> torch.Tensor:
        """What :meth:`all_to_all` received, in position order (after its
        work handle was waited on)."""
        return recv if self.size == 1 else self._from_group_order(recv)


def group_for(mesh, axes: Sequence[str]) -> Group:
    """The :class:`Group` of this rank over ``axes`` of ``mesh`` (in that
    order).  One axis is ``mesh.get_group(axis)``; several axes get groups
    of their own (``new_group`` for each fixing of the other axes, called
    by every rank in the same order, as it must be), built once per mesh
    and axis order and kept on the mesh."""
    axes = tuple(axes)
    cache = mesh.__dict__.setdefault("_repro_torch_groups", {})
    if axes in cache:
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    size = math.prod(int(ranks.shape[names.index(a)]) for a in axes)
    me = tdist.get_rank() if tdist.is_initialized() else 0
    others = [i for i, a in enumerate(names) if a not in axes]
    rows = ranks.permute(others + [names.index(a) for a in axes]).reshape(-1, size).tolist()
    row = next(r for r in rows if me in r)
    if size == 1:
        grp = Group(None, 1, 0)
    else:
        if len(axes) == 1:
            pg = mesh.get_group(axes[0])
        else:
            made = [tdist.new_group(r) for r in rows]  # every rank makes every group
            pg = made[rows.index(row)]
        perm = tuple(tdist.get_group_rank(pg, r) for r in row)
        grp = Group(pg, size, row.index(me), None if perm == tuple(range(size)) else perm)
    cache[axes] = grp
    return grp


# --------------------------------------------------------------------------
# per-rank pieces


def _mix(*parts: int) -> int:
    """A 63-bit seed from integers (splitmix64 steps): the same parts give
    the same seed in every process."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = ((h ^ (int(p) & _MASK64)) * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 31
    return h >> 1


def sample_positions(seed: int, level_idx: int, round_: int, rank: int, num: int,
                     m: torch.Tensor) -> torch.Tensor:
    """``num`` uniform sample positions (int64) in [0, m) on ``m``'s device,
    from a generator seeded from (seed, level, round, rank) alone: the
    reference's ``fold_in`` chain in spirit (history-independent), not in
    bits.  The one place the exchange draws, so tests can feed both
    packages the same positions."""
    gen = torch.Generator(device=m.device).manual_seed(_mix(seed, level_idx, round_, rank))
    return sampling.sample_indices(gen, num, torch.zeros_like(m), m)


def _k2_tile(tile: int) -> int:
    return max(1, min(tile, MAX_TILE))


def compact_valid(arrays: Arrays, valid: torch.Tensor, tile: int) -> Arrays:
    """Stably move the valid elements to the front: a 2-bucket partition,
    K2 on a CUDA tensor.  Key order among valid elements is kept.

    >>> out = compact_valid({"k": torch.tensor([9, 7, 8, 6])},
    ...                     torch.tensor([False, True, False, True]), 2)
    >>> out["k"].tolist()
    [7, 6, 9, 8]
    """
    ids = torch.where(valid, 0, 1).to(torch.int32)
    dest, _ = rank_hist(ids, nb=2, tile=_k2_tile(tile))
    return _scatter(arrays, dest)


def _classify(keys: torch.Tensor, spl: torch.Tensor, valid: torch.Tensor,
              groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination group per element (pads -> trash bucket ``groups``) and
    per-group counts, with equality-bucket striping across splitter runs."""
    n = keys.shape[0]
    lo = torch.searchsorted(spl, keys, side="left")
    hi = torch.searchsorted(spl, keys, side="right")
    span = hi - lo + 1
    # stripe by a multiplicative hash of the position, not the position: a
    # structured input (EightDup's i^8 lattice) puts every copy of a heavy
    # value at one residue class, which pos % span would send to one group
    pos = (torch.arange(n, dtype=torch.int64, device=keys.device) * 2654435761) & 0xFFFFFFFF
    stripe = (pos >> 16) % torch.clamp(span, min=1)
    dest = torch.clamp(lo + stripe, max=groups - 1)
    dest = torch.where(valid, dest, groups).to(torch.int32)
    counts = torch.bincount(dest, minlength=groups + 1)[:groups]
    return dest, counts


def _radix_dest(keys: torch.Tensor, valid: torch.Tensor,
                groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Destination group from the top log2(groups) bits of the reference's
    unsigned code (pads -> trash bucket ``groups``) and per-group counts.
    The port's codes are signed (the unsigned code with its sign bit
    flipped), so the arithmetic shift plus 2^(b-1) gives those bits."""
    b = groups.bit_length() - 1
    bits = torch.iinfo(keys.dtype).bits
    dest = (keys >> (bits - b)).to(torch.int64) + (1 << (b - 1))
    dest = torch.where(valid, dest, groups).to(torch.int32)
    counts = torch.bincount(dest, minlength=groups + 1)[:groups]
    return dest, counts


def _observed_cumulative(keys: torch.Tensor, valid: torch.Tensor, cands: torch.Tensor,
                         dom: Group) -> torch.Tensor:
    """Global number of keys strictly below each candidate point (one
    ``all_reduce`` SUM)."""
    m = cands.shape[0]
    below = torch.searchsorted(cands, keys, side="right")
    below = torch.where(valid, below, m + 1)  # pads count nowhere
    hist = torch.bincount(below, minlength=m + 2)
    cum = torch.cumsum(hist, 0)[:m]
    return dom.all_reduce(cum, tdist.ReduceOp.SUM)


def _row_bytes(arrays: Arrays) -> int:
    """Bytes one element carries across the wire: its key and a row of
    every payload leaf."""
    return sum(a.element_size() * math.prod(a.shape[1:]) for a in arrays.values())


def _degenerate(arrays: Arrays, m: torch.Tensor, level: Level,
                level_idx: int) -> Tuple[Arrays, torch.Tensor, torch.Tensor]:
    """A one-rank axis: no collective, padded (or truncated, with the
    flag, the d > 1 contract) to n_out.  A truncated buffer keeps its first
    n_out slots: all valid when m > n_out, else the kept tail is pads."""
    n = arrays["k"].shape[0]
    n_out = level.n_out
    overflow = m > n_out
    obs.jit_event(
        "dist.exchange_overflow", {"m": m}, gate=overflow,
        warn=(f"repro_torch.dist: degenerate level {level_idx} buffer "
              f"(n_out={n_out}) overflowed; truncating"),
        level=str(level_idx), groups=1, capacity=n_out,
    )
    if n_out >= n:
        out = {}
        for name, a in arrays.items():
            o = torch.zeros((n_out,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
            o[:n] = a
            out[name] = o
        out["k"][n:] = sampling.sentinel_for(out["k"].dtype)
    else:
        out = {name: a[:n_out] for name, a in arrays.items()}
    return out, torch.clamp(m, max=n_out), overflow


def exchange_level(
    arrays: Arrays,
    m: torch.Tensor,
    level: Level,
    *,
    domain: Group,
    axis: Group,
    tile: int,
    seed: int,
    level_idx: int,
    retries: int = 2,
    classifier: str = "tree",
    overlap: bool = False,
) -> Tuple[Arrays, torch.Tensor, torch.Tensor]:
    """Run one level's exchange on this rank's ``arrays``.

    ``arrays["k"]`` holds (n_in,) encoded keys with the valid prefix [0, m)
    (``m`` a 0-d int64 tensor; sentinel pads beyond); every other entry is
    a payload leaf riding the same partitions.  ``domain`` is the group
    over the level's domain axes and ``axis`` the group over its exchanged
    axis (:func:`group_for`).  Returns (arrays (n_out,), m', overflowed (0-d
    bool)); ``overflowed`` is True only when every re-split round still
    exceeded capacity somewhere in the domain (the exchange then truncated
    deterministically).

    ``classifier="radix"`` takes the bit-range destinations at round 0 when
    the group count is a power of two; re-split rounds are always
    splitter-based.  ``overlap=True`` takes the half-shard staggered
    exchange (bit-identical); it stays synchronous on an odd shard size.

    The degenerate (groups == 1) level needs no collective:

    >>> from repro_torch.dist.levels import plan_schedule
    >>> (lv,) = plan_schedule({"data": 1}, "data", 256)
    >>> one = Group(None, 1, 0)
    >>> out, m, ovf = exchange_level(
    ...     {"k": torch.arange(256, dtype=torch.int32)}, torch.tensor(256), lv,
    ...     domain=one, axis=one, tile=64, seed=0, level_idx=0)
    >>> (out["k"].shape[0], int(m), bool(ovf))   # padded to n_out, no loss
    (512, 256, False)
    """
    g, cap = level.groups, level.capacity
    if g == 1:
        return _degenerate(arrays, m, level, level_idx)
    keys = arrays["k"]
    n, dev = keys.shape[0], keys.device
    valid = torch.arange(n, device=dev) < m
    track = obs.enabled()
    round_fill: List[float] = []
    rounds_used = 0
    use_radix = classifier == "radix" and g & (g - 1) == 0
    dest_keep, done = None, False
    for r in range(max(0, retries) + 1):
        if r == 0 and use_radix:
            dest, counts = _radix_dest(keys, valid, g)
        else:
            pos = sample_positions(seed, level_idx, r, domain.index, level.oversample, m)
            cands = torch.sort(domain.all_gather(keys[pos])).values
            if r == 0:
                spl = sampling.select_splitters(cands, g)
            else:
                # observed-histogram re-split: exact global ranks at the
                # fresh candidate points replace the failed sample estimate
                cum = _observed_cumulative(keys, valid, cands, domain)
                total = domain.all_reduce(m.reshape(1).clone(), tdist.ReduceOp.SUM)[0]
                spl = sampling.splitters_from_histogram(cands, cum, g, total)
            dest, counts = _classify(keys, spl, valid, g)
        # the round's one host read: the largest chunk anywhere in the
        # domain, the same reduced value on every rank of it
        largest = int(domain.all_reduce(counts.max().reshape(1), tdist.ReduceOp.MAX).item())
        dest_keep = dest
        rounds_used += 1
        if track:
            # in float32, times the reciprocal: the reference's compiled
            # division by the constant capacity, bit for bit
            round_fill.append(float(np.float32(largest) * (np.float32(1) / np.float32(cap))))
        if largest <= cap:
            done = True
            break
    overflowed = not done
    if track:
        is_lead = domain.index == 0
        obs.jit_observe("dist.resplit_rounds", rounds_used, gate=is_lead,
                        level=str(level_idx), axis=str(level.axis))
        obs.jit_event(
            "dist.exchange_overflow",
            {"round_fill": torch.tensor(round_fill, dtype=torch.float32),
             "rounds_used": rounds_used},
            gate=overflowed and is_lead,
            warn=(f"repro_torch.dist: capacity exhausted after {max(0, retries) + 1} "
                  f"round(s) at level {level_idx} (axis {level.axis!r}, capacity {cap}); "
                  f"truncating overflowing chunks"),
            level=str(level_idx), groups=g, capacity=cap,
        )
    flag = torch.full((), overflowed, dtype=torch.bool, device=dev)
    if overlap and n % 2 == 0:
        out, m_next = _exchange_halves(arrays, dest_keep, level, axis, tile, level_idx)
        return out, m_next, flag

    # stable partition with a trash bucket for the pads (never sent)
    place, offsets = rank_hist(dest_keep, nb=g + 1, tile=_k2_tile(tile))
    parts = _scatter(arrays, place)
    counts = (offsets[1:g + 1] - offsets[:g]).to(torch.int64)
    send = torch.clamp(counts, max=cap)  # truncation only past the last round
    if track:
        per_elem = _row_bytes(parts)
        obs.jit_observe("dist.collective_bytes", send.sum().to(torch.float32) * per_elem,
                        level=str(level_idx), axis=str(level.axis),
                        padded_bytes=g * cap * per_elem)
    recv, recv_counts, _ = _send(parts, offsets, send, level, axis, async_op=False)
    flat = {name: _unpack(axis, got) for name, got in recv.items()}
    recv_counts = axis.arrivals(recv_counts)
    arrived = (torch.arange(cap, device=dev)[None, :] < recv_counts[:, None]).reshape(-1)
    return compact_valid(flat, arrived, tile), recv_counts.sum(), flag


def _send(parts: Arrays, offsets: torch.Tensor, send: torch.Tensor, level: Level,
          axis: Group, async_op: bool):
    """Pack each group's first ``send`` elements of the partitioned
    ``parts`` into its ``capacity`` slots (keys padded with the sentinel,
    payloads with zeros) and issue one ``all_to_all_single`` per tensor and
    one for the counts.  Returns ({name: (received bytes, dtype, shape)},
    received counts, work handles: None each unless ``async_op``); read
    the arrivals with :func:`_unpack` after the handles are waited on."""
    g, cap = level.groups, level.capacity
    n = parts["k"].shape[0]
    dev = parts["k"].device
    slot = torch.arange(cap, device=dev)
    gidx = torch.clamp(offsets[:g, None].to(torch.int64) + slot[None, :], max=n - 1).reshape(-1)
    in_cap = (slot[None, :] < send[:, None]).reshape(-1)
    recv, works = {}, []
    for name, a in parts.items():
        fill = sampling.sentinel_for(a.dtype) if name == "k" else 0
        mask = in_cap.reshape((-1,) + (1,) * (a.dim() - 1))
        frame = torch.where(mask, a[gidx], torch.full((), fill, dtype=a.dtype, device=dev))
        # collectives move bytes: every dtype (bool, uint16, ...) travels
        # as uint8 rows and is viewed back on arrival
        got, work = axis.all_to_all(frame.reshape(g * cap, -1).view(torch.uint8), async_op)
        recv[name] = (got, frame.dtype, tuple(frame.shape))
        works.append(work)
    got_counts, work = axis.all_to_all(send, async_op)
    works.append(work)
    return recv, got_counts, works


def _unpack(axis: Group, got) -> torch.Tensor:
    x, dtype, shape = got
    return axis.arrivals(x).view(dtype).reshape(shape)


def _exchange_halves(arrays: Arrays, dest_keep: torch.Tensor, level: Level, axis: Group,
                     tile: int, level_idx: int) -> Tuple[Arrays, torch.Tensor]:
    """The staggered tail of an overlapped exchange (module docstring).

    The destinations and the overflow verdict are fixed over the whole
    shard; each position-half is partitioned and packed separately, and
    half A's collectives are issued (``async_op=True``) before half B's
    partition starts.  Bit identity with the synchronous tail: (a) the
    stable partition of a position-prefix is a prefix of the stable
    partition of the whole, so per (sender, group) the A-chunk's elements
    precede the B-chunk's; (b) the shared budget keeps exactly the first
    ``min(counts, cap)`` of that order; (c) arrivals concatenate per sender
    as [A-slots | B-slots], which the stable compaction flattens back into
    the synchronous arrival order."""
    n = arrays["k"].shape[0]
    g, cap = level.groups, level.capacity
    dev = arrays["k"].device
    h = n // 2
    budget = torch.full((g,), cap, dtype=torch.int64, device=dev)
    halves = []
    for lo in (0, h):
        sub = {name: a[lo:lo + h] for name, a in arrays.items()}
        place, offsets = rank_hist(dest_keep[lo:lo + h], nb=g + 1, tile=_k2_tile(tile))
        parts = _scatter(sub, place)
        counts = (offsets[1:g + 1] - offsets[:g]).to(torch.int64)
        send = torch.minimum(counts, budget)  # B spends what A left over
        budget = budget - send
        # issued here, before half B's partition: nothing waits on these
        # collectives until the reassembly below
        halves.append((send,) + _send(parts, offsets, send, level, axis, async_op=True))
    if obs.enabled():
        per_elem = _row_bytes(arrays)
        bytes_a = halves[0][0].sum().to(torch.float32) * per_elem
        bytes_b = halves[1][0].sum().to(torch.float32) * per_elem
        obs.jit_observe("dist.collective_bytes", bytes_a + bytes_b, level=str(level_idx),
                        axis=str(level.axis), padded_bytes=2 * g * cap * per_elem, overlap="on")
        # the fraction of this level's payload whose transfer can hide
        # behind local partition work (half A's bytes overlap half B's)
        obs.jit_observe("dist.overlap_efficiency",
                        bytes_a / torch.clamp(bytes_a + bytes_b, min=1.0),
                        level=str(level_idx), axis=str(level.axis))
    for _, _, _, works in halves:
        for work in works:
            if work is not None:
                work.wait()
    slot = torch.arange(cap, device=dev)
    flat, arrived, m_next = {}, [], 0
    for name in arrays:
        both = [_unpack(axis, recv[name]) for _, recv, _, _ in halves]
        cat = torch.cat([b.reshape((g, cap) + tuple(b.shape[1:])) for b in both], dim=1)
        flat[name] = cat.reshape((2 * g * cap,) + tuple(cat.shape[2:]))
    for _, _, got_counts, _ in halves:
        rc = axis.arrivals(got_counts)
        arrived.append(slot[None, :] < rc[:, None])
        m_next = m_next + rc.sum()
    valid = torch.cat(arrived, dim=1).reshape(-1)
    out = compact_valid(flat, valid, tile)
    # every slot past n_out is invalid (m_next <= g * cap by the shared
    # budget), so the cut drops only pads the compaction pushed behind
    return {name: a[:g * cap] for name, a in out.items()}, m_next
