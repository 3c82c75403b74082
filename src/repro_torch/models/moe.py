"""Mixture-of-Experts layer with sort-based token dispatch.

Counterpart of ``repro.models.moe`` (``expert_capacity``, ``init_moe``,
``sort_dispatch``, ``moe_ffn``).  Routing n tokens to E experts is the
paper's distribution problem with the router's expert id as the
classifier: a stable counting placement groups the (token, k) entries
into contiguous per-expert runs, and the entries an expert ranks beyond
its capacity land in a trash slot (the overflow block).

On the card the stable ranks come from kernel K6: ``dispatch_ranks`` for
one routing problem, ``partition_ranks_batched`` for (L, n*k) rows (every
MoE layer of a step at once).  On the CPU they come from the plain
``core.partition.partition_permutation``, the reference's own formula, so
``slot``, ``kept`` and ``counts`` are bit-identical to the reference's.

``moe_ffn`` follows the reference's flow: a float32 router softmax, top-k
and renormalisation, a scatter into the (E*cap + 1, D) buffer, the grouped
SwiGLU as batched matrix products (``torch.bmm``; a plain product outside
any kernel in the reference too), the gather back and a float32
combine (the reference's scatter-add over tokens as a sum over each
token's k adjacent entries: no float atomics, so two calls agree bit for
bit on the card), plus the shared experts.  Under autograd the gradients
flow through the scatter into the grouped buffer, the gather back, the
k-sum, the renormalised gates and ``lb_loss`` (through the router's mean
probabilities); ``slot``, ``kept`` and ``counts`` are integers and carry
none.  K6 runs in every forward, and again in every recompute when the
model rematerialises its layers for the backward.

Under an ambient ``DeviceMesh`` (``layers.ambient_mesh``) the activations
are DTensors, and the routed experts run as per-rank code over the mesh's
``model`` group (``_routed_mesh``): the expert banks stay E-sharded over
``model``, each rank runs its E/TP local experts with the foreign entries
in a trash bucket ranked by K6, and one sum all-reduce over ``model`` adds
the columns.  The baseline ranks every token of the batch (a global
capacity: the tokens are gathered over the dp axes, as the reference's
hint on the grouped buffer has it); with ``ComputePolicy.explicit_ep`` and
a ``model`` axis dividing E, ``moe_ffn`` takes the reference's
expert-parallel column, whose capacity is per dp shard and whose tokens
stay where they are.  Without a mesh the flag changes nothing, as in the
reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.partition import partition_permutation
from repro_torch.kernels import _build, dispatch_rank
from repro_torch.models.layers import (
    Dense, SwiGLU, current_mesh, dense, frozen, init_dense, init_device, shard_hint, swiglu,
)
from repro_torch.models.policy import current_policy
from repro_torch.ops.sort import Device

__all__ = ["Experts", "MoE", "init_moe", "moe_ffn", "sort_dispatch", "expert_capacity"]


class Experts(nn.Module):
    """The stacked expert weights: gate and up (E, D, F), down (E, F, D)."""

    def __init__(self, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
        super().__init__()
        self.gate, self.up, self.down = frozen(gate), frozen(up), frozen(down)


class MoE(nn.Module):
    """A float32 ``router`` (D, E), the ``experts`` and, when the config has
    shared experts, one ``shared`` SwiGLU."""

    def __init__(self, router: Dense, experts: Experts, shared: Optional[SwiGLU] = None):
        super().__init__()
        self.router, self.experts, self.shared = router, experts, shared


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    cap = int(math.ceil(num_tokens * top_k / num_experts * capacity_factor))
    return max(8, -(-cap // 8) * 8)


def init_moe(
    gen: torch.Generator,
    d_model: int,
    *,
    num_experts: int,
    d_ff_expert: int,
    top_k: int,
    num_shared: int = 0,
    d_ff_shared: int = 0,
    dtype=torch.bfloat16,
    device: Device = None,
) -> MoE:
    """The reference's distributions: a float32 router, experts ~ N(0, 1/D)
    (down ~ N(0, 1/F)) in ``dtype``, shared experts of ``d_ff_shared`` (or
    ``d_ff_expert * num_shared``) hidden units."""
    device = init_device(gen, device)
    scale = 1.0 / math.sqrt(d_model)
    router = init_dense(gen, d_model, num_experts, dtype=torch.float32, device=device)

    def normal(shape, s):
        return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
                * s).to(dtype)

    experts = Experts(normal((num_experts, d_model, d_ff_expert), scale),
                      normal((num_experts, d_model, d_ff_expert), scale),
                      normal((num_experts, d_ff_expert, d_model), 1.0 / math.sqrt(d_ff_expert)))
    shared = None
    if num_shared:
        dff = d_ff_shared or d_ff_expert * num_shared
        kw = dict(dtype=dtype, device=device)
        shared = SwiGLU(init_dense(gen, d_model, dff, **kw), init_dense(gen, d_model, dff, **kw),
                        init_dense(gen, dff, d_model, **kw))
    return MoE(router, experts, shared)


def _stable_dest(expert_id: torch.Tensor, num_experts: int, tile: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest (L, m) int32, offsets (L, E+1) int32): each entry's position in
    its row's stable expert-major order, and the rows' expert boundaries."""
    L, m = expert_id.shape
    dev = expert_id.device
    if dev.type == "cpu" and not _build.is_fake(expert_id):
        t = min(tile, m)
        if m % t:
            t = m
        dest = torch.empty((L, m), dtype=torch.int32)
        offsets = []
        for row in range(L):
            perm, off = partition_permutation(expert_id[row], num_experts, t)
            dest[row, perm] = torch.arange(m, dtype=torch.int32)
            offsets.append(off)
        return dest, torch.stack(offsets)
    counts = torch.zeros((L, num_experts), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, expert_id.to(torch.int64), torch.ones_like(expert_id))
    offsets = torch.zeros((L, num_experts + 1), dtype=torch.int32, device=dev)
    offsets[:, 1:] = torch.cumsum(counts, 1, dtype=torch.int32)
    start = offsets[:, :-1].contiguous()
    if L == 1:  # K6 in its one-problem form
        dest = dispatch_rank.dispatch_ranks(expert_id[0].contiguous(), start[0],
                                            num_experts=num_experts)[None]
    else:
        dest = dispatch_rank.partition_ranks_batched(expert_id.contiguous(), start,
                                                     nb=num_experts)
    return dest, offsets


def sort_dispatch(
    expert_id: torch.Tensor,   # (n*k,) or (L, n*k) int32 expert assignment
    num_experts: int,
    capacity: int,
    *,
    tile: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The paper's partition machinery applied to MoE routing.

    Returns (slot, kept, counts): ``slot`` (n*k,) int32 is the entry's slot
    in the (E*capacity,) grouped buffer, E*capacity (the trash slot) for
    an entry its expert ranks at ``capacity`` or beyond; ``kept`` (n*k,)
    bool; ``counts`` (E,) int32 entries per expert before the clamp.  A
    2-D ``expert_id`` (L, n*k) dispatches L independent problems at once,
    each output gaining the leading L.  ``tile`` is the plain twin's tile
    (the reference's signature); the placement does not depend on it.
    """
    if expert_id.dim() not in (1, 2):
        raise ValueError(f"expert_id must be (n*k,) or (L, n*k), got {tuple(expert_id.shape)}")
    ids = expert_id.to(torch.int32)
    rows = ids if ids.dim() == 2 else ids[None]
    dest, offsets = _stable_dest(rows, num_experts, tile)
    rank = dest - torch.gather(offsets[:, :-1], 1, rows.to(torch.int64))
    kept = rank < capacity
    slot = torch.where(kept, rows * capacity + rank,
                       torch.full_like(rank, num_experts * capacity))
    counts = offsets[:, 1:] - offsets[:, :-1]
    if ids.dim() == 1:
        return slot[0], kept[0], counts[0]
    return slot, kept, counts


def _expert_mlp(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                xg: torch.Tensor) -> torch.Tensor:
    """xg: (E, cap, D) -> (E, cap, D); the grouped SwiGLU."""
    g = torch.bmm(xg, gate)
    u = torch.bmm(xg, up)
    return torch.bmm(F.silu(g) * u, down)


def _routed(xf, gate_vals, eids, gate, up, down, *, num_experts, top_k, cap):
    """The baseline's routed experts on plain tensors, without a mesh: (y
    (n, D) float32, dropped, counts (E,))."""
    n, d = xf.shape
    flat_e = eids.reshape(n * top_k).to(torch.int32)
    slot, kept, counts = sort_dispatch(flat_e, num_experts, cap)
    slot64 = slot.to(torch.int64)

    # scatter tokens into the grouped (E, cap) buffer (trash slot at the end)
    # entry j is token j // top_k: the reference's xf[tok_idx] as a
    # broadcast, whose gradient sums each token's k entries in one order
    # (the gather's transpose accumulates rows, by float atomics on a CPU)
    buf = torch.zeros((num_experts * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot64] = xf[:, None, :].expand(n, top_k, d).reshape(n * top_k, d)
    yg = _expert_mlp(gate, up, down, buf[:-1].reshape(num_experts, cap, d))
    yg = torch.cat([yg.reshape(num_experts * cap, d), yg.new_zeros((1, d))])

    # combine: gather back and weight; dropped entries read the zero trash
    # slot.  A token's k entries are adjacent, so the reference's scatter-add
    # over tok_idx is a sum over k: no float atomics, one order every call
    wts = (gate_vals.reshape(n * top_k) * kept).to(torch.float32)
    y = (yg[slot64].to(torch.float32) * wts[:, None]).reshape(n, top_k, d).sum(dim=1)
    return y, torch.sum(~kept).to(torch.int32), counts


def _column(xf, gate_vals, eids, gate, up, down, *, top_k, cap, e_loc, lo, num_experts):
    """One model column of the routed experts on plain tensors: the (token,
    k) entries routed to the column's ``e_loc`` local experts (those from
    ``lo`` on) are ranked by K6 among the others, which all go to the trash
    bucket ``e_loc``; returns the column's partial (y (n, D) float32,
    dropped, counts (num_experts,), zero but for its experts').  An
    expert's entries keep their order, so their ranks, and the slots they
    keep below ``cap``, are those of the one-bucket-per-expert dispatch."""
    nl, d = xf.shape
    flat_e = eids.reshape(nl * top_k).to(torch.int32)
    local_e = flat_e - lo
    mine = (local_e >= 0) & (local_e < e_loc)
    # foreign entries land in pseudo-bucket e_loc; its slots are never fed
    # to an expert (the trash region of the buffer)
    bucket = torch.where(mine, local_e, torch.full_like(local_e, e_loc))
    slot, kept, counts = sort_dispatch(bucket, e_loc + 1, cap)
    kept = kept & mine
    slot64 = slot.to(torch.int64)
    buf = torch.zeros(((e_loc + 1) * cap + 1, d), dtype=xf.dtype, device=xf.device)
    buf[slot64] = xf[:, None, :].expand(nl, top_k, d).reshape(nl * top_k, d)
    yg = _expert_mlp(gate, up, down, buf[:e_loc * cap].reshape(e_loc, cap, d))
    yg = torch.cat([yg.reshape(e_loc * cap, d), yg.new_zeros((cap + 1, d))])  # trash reads 0
    wts = (gate_vals.reshape(nl * top_k) * kept).to(torch.float32)
    y = (yg[slot64].to(torch.float32) * wts[:, None]).reshape(nl, top_k, d).sum(dim=1)
    full = torch.zeros(num_experts, dtype=counts.dtype, device=counts.device)
    full[lo:lo + e_loc] = counts[:e_loc]
    return y, torch.sum(mine & ~kept).to(torch.int32), full


def _routed_mesh(p: MoE, xf, gate_vals, eids, *, num_experts, top_k, capacity_factor,
                 mesh, per_dp_shard: bool):
    """The routed experts over a ``DeviceMesh``, as per-rank code
    (``_column``) over its ``model`` group, with the expert banks left
    E-sharded over ``model`` (``launch.shardings``' EP rule).  Each rank
    runs its column's E/TP experts and returns a partial sum over
    ``model``; one sum all-reduce adds the columns (an autograd-aware
    redistribution, so the backward passes through it), and ``dropped``
    and ``counts`` are summed over the columns (each holds its experts'
    entries and its slice of the counts), so both equal the baseline's.

    * ``per_dp_shard`` (``ComputePolicy.explicit_ep``, the reference's
      ``_moe_ep_shard_map``): the Megatron-TP contract makes activations
      entering the FFN replicated over ``model``, so every column already
      holds its dp shard's tokens: no dispatch all-to-all.  The capacity is
      per dp shard, and ``dropped`` and ``counts`` are also summed over the
      dp axes.  ``dropped`` counts the entries every column dropped (the
      reference returns one column's as if replicated), so it equals the
      baseline's.
    * otherwise the baseline: the capacity is global, so every rank ranks
      every token of the batch (the tokens, gates and ids gathered over the
      dp axes: activations, not expert banks) and runs its column's experts
      on the whole grouped buffer, replicated over the dp axes.  That is
      the reference's program, whose hint keeps the grouped buffer
      expert-major over ``model`` and replicated over the rest.

    Where the mesh has no ``model`` axis, or it does not divide E, the
    one column is every expert and the banks are gathered whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    tp = names.index("model") if "model" in names else None
    if tp is not None and num_experts % mesh.size(tp):
        tp = None
    dp = [i for i, a in enumerate(names) if a in ("pod", "data")]
    n, d = xf.shape
    if per_dp_shard:
        dp_total = 1
        for i in dp:
            dp_total *= mesh.size(i)
        # each column only ever sees n/dp tokens
        cap = expert_capacity(n // dp_total, num_experts, top_k, capacity_factor)
    else:
        cap = expert_capacity(n, num_experts, top_k, capacity_factor)
    e_loc = num_experts if tp is None else num_experts // mesh.size(tp)
    lo = 0 if tp is None else mesh.get_local_rank(tp) * e_loc

    def per_dim(on_tp, on_dp, other=Replicate()):
        # without a model column (tp None) ``on_tp`` goes nowhere: whole
        # outputs and whole banks
        return tuple(on_tp if i == tp else on_dp if i in dp else other
                     for i in range(mesh.ndim))

    tok_dp = Shard(0) if per_dp_shard else Replicate()
    tok = per_dim(Replicate(), tok_dp)
    exp = per_dim(Shard(0), Replicate())
    # a column's outputs are partial sums over the model columns; over the
    # dp axes the EP column's tokens are its shard's (its counts a part of
    # the sum), the baseline's every rank's alike
    y_pl = per_dim(Partial(), tok_dp)
    summed = per_dim(Partial(), Partial() if per_dp_shard else Replicate())
    # a column's input gradients: the tokens' are partial over the model
    # columns (each holds its own experts' part); the experts' partial over
    # the EP column's dp shards (each holds its own tokens' part), whole on
    # every baseline rank
    tok_grad = per_dim(Partial(), tok_dp)
    exp_grad = per_dim(Shard(0), Partial() if per_dp_shard else Replicate())

    def as_dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim)

    ex = p.experts
    column = local_map(
        lambda *a: _column(*a, top_k=top_k, cap=cap, e_loc=e_loc, lo=lo,
                           num_experts=num_experts),
        out_placements=(y_pl, summed, summed),
        in_placements=(tok, tok, tok, exp, exp, exp),
        in_grad_placements=(tok_grad, tok_grad, tok, exp_grad, exp_grad, exp_grad),
        redistribute_inputs=True, device_mesh=mesh)
    y, dropped, counts = column(*(as_dt(t) for t in (xf, gate_vals, eids, ex.gate, ex.up,
                                                   ex.down)))
    # the Megatron row-parallel reduce (the one collective of the EP path),
    # back to the tokens' own placements
    back = tuple(Replicate() if pl.is_partial() else pl for pl in as_dt(xf).placements)
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    return (y.redistribute(mesh, back), dropped.redistribute(mesh, rep),
            counts.redistribute(mesh, rep))


def _ep_applies(num_experts: int):
    """The ambient mesh when the expert-parallel column runs (the policy
    asks for it, the mesh has a ``model`` axis and that axis divides E)."""
    mesh = current_mesh()
    if not current_policy().explicit_ep or mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names or ())
    if "model" not in names or num_experts % mesh.size(names.index("model")):
        return None
    return mesh


def moe_ffn(
    p: MoE,
    x: torch.Tensor,   # (B, S, D)
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    router_softmax_after: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (output (B, S, D) in x's dtype, aux): ``aux`` holds the
    Switch-style ``lb_loss`` (float32), ``dropped`` (int32, the entries
    beyond capacity) and ``max_load`` (int32, the largest count)."""
    from torch.distributed.tensor import DTensor

    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    logits = dense(p.router, xf.to(torch.float32))  # (n, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, eids = torch.topk(probs, top_k, dim=-1)  # (n, k)
    if router_softmax_after:
        gate_vals = gate_vals / (gate_vals.sum(dim=-1, keepdim=True) + 1e-9)

    ex = p.experts
    ep_mesh = _ep_applies(num_experts)
    if ep_mesh is not None or isinstance(xf, DTensor):
        y, dropped, counts = _routed_mesh(
            p, xf, gate_vals, eids, num_experts=num_experts, top_k=top_k,
            capacity_factor=capacity_factor, mesh=ep_mesh or xf.device_mesh,
            per_dp_shard=ep_mesh is not None)
    else:
        cap = expert_capacity(n, num_experts, top_k, capacity_factor)
        y, dropped, counts = _routed(xf, gate_vals, eids, ex.gate, ex.up, ex.down,
                                     num_experts=num_experts, top_k=top_k, cap=cap)
    if p.shared is not None:
        y = y + swiglu(p.shared, xf).to(torch.float32)

    me = probs.mean(dim=0)                              # (E,)
    ce = counts.to(torch.float32) / (n * top_k)
    aux = {
        "lb_loss": num_experts * torch.sum(me * ce),
        "dropped": dropped,
        "max_load": counts.max(),
    }
    return y.reshape(b, s, d).to(x.dtype), aux
