"""Sharding rules: the TP/FSDP/EP contract for every architecture.

Counterpart of ``repro.launch.shardings``.  One rule table maps each
parameter's leaf path (the reference's, ``models.transformer.param_leaves``)
to a logical sharding on the (pod, data, model) production mesh:

  * **TP** (``model`` axis): attention heads / FFN hidden / vocab are
    column-sharded on their "parallel" matrices (wq/wk/wv, gate/up,
    lm_head, embed) and row-sharded on the reducing ones (wo, down);
  * **FSDP/ZeRO** (``data`` (+``pod``) axes): the non-TP dim of every large
    matrix is also sharded over the dp axes; optimizer moments are
    elementwise, so they inherit it;
  * **EP**: expert tensors (E, ..) shard E over ``model``;
  * small vectors and scalars are replicated.

A rule returns a :class:`Spec`: per tensor dimension an axis name, a tuple
of names, or None, as the reference's ``PartitionSpec`` (a ``Spec`` is a
tuple, so the two compare directly).  The reference stacks a layer's
tensors over the layers and puts a leading None for that dimension; the
port holds one tensor per layer and gives each the spec without it.
``placements`` (defined with ``shard_hint`` in ``models.layers``, below
both packages) turns a spec into DTensor placements on a ``DeviceMesh``: a dimension sharded over ``("pod", "data")`` is
``Shard(d)`` on both mesh dimensions, pod the major one.  DTensor does not
pad an uneven dimension (8 KV heads over 16 ranks, a batch of 1) as GSPMD
does: its shards follow ``torch.chunk``, and some are empty.

``distribute_model`` places a ``Transformer``'s parameters by
:func:`param_specs`; ``distribute`` places any tree of tensors (a batch,
a cache, an optimizer state) by a congruent tree of specs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes
from repro_torch.models.layers import placements

__all__ = ["ShardingStrategy", "Spec", "param_specs", "batch_specs", "cache_specs",
           "named", "logits_spec", "placements", "distribute", "distribute_model",
           "leaf_path", "local_shape"]


def _norm_axis(a):
    """A dimension's axes as ``PartitionSpec`` keeps them: a one-name tuple
    is the name, an empty one None."""
    if a is None or isinstance(a, str):
        return a
    a = tuple(a)
    return None if not a else a[0] if len(a) == 1 else a


class Spec(tuple):
    """Per-dimension mesh axes: ``Spec("data", None)``, ``Spec(("pod",
    "data"), "model")``; ``Spec()`` is a replicated scalar.  Normalised as
    the reference's ``PartitionSpec`` is, so the two compare equal."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(_norm_axis(a) for a in axes))

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(tuple(self))


@dataclass(frozen=True)
class ShardingStrategy:
    """Tunable regime knobs."""
    fsdp_params: bool = True       # shard params over dp axes (ZeRO-3)
    seq_shard_cache: Optional[bool] = None  # None: auto by kv-head divisibility
    shard_moe_router: bool = False
    embed_vocab_axis: str = "model"  # "model" | "none"


def _tp_size(mesh) -> int:
    return axis_sizes(mesh)["model"]


def _rule(pstr: str, core: Sequence[int], cfg: ModelConfig, mesh,
          strat: ShardingStrategy) -> Spec:
    """The spec of leaf ``pstr`` whose per-layer shape is ``core``."""
    dp = dp_axes(mesh) if strat.fsdp_params else None
    tp = "model"
    spec = Spec

    leaf = pstr.split("/")[-1]
    parent = pstr.split("/")[-2] if "/" in pstr else ""

    # ---- embeddings / head -------------------------------------------------
    if pstr == "embed":
        va = tp if strat.embed_vocab_axis == "model" else None
        return Spec(va, dp)
    if parent == "lm_head" and leaf in ("w",):
        return Spec(dp, tp)

    # ---- MoE expert banks (E, din, dout) -----------------------------------
    if "experts" in pstr and len(core) == 3:
        if leaf in ("gate", "up"):
            return spec(tp, dp, None)
        return spec(tp, None, dp)  # down
    if "router" in pstr:
        return spec(dp, None) if strat.shard_moe_router else spec(None, None)

    # ---- attention ----------------------------------------------------------
    if parent in ("wq", "wk", "wv") and leaf == "w":
        return spec(dp, tp)
    if parent in ("wq", "wk", "wv") and leaf == "b":
        return spec(tp)
    if parent == "wo" and leaf == "w":
        return spec(tp, dp)

    # ---- dense / shared-expert MLPs ----------------------------------------
    if parent in ("gate", "up") and leaf == "w":
        return spec(dp, tp)
    if parent == "down" and leaf == "w":
        return spec(tp, dp)
    if leaf == "b":
        return spec(None)

    # ---- mamba2 -------------------------------------------------------------
    if parent == "in_proj" and leaf == "w":
        return spec(dp, tp)
    if parent == "out_proj" and leaf == "w":
        return spec(tp, dp)
    if leaf == "conv_w":
        return spec(None, tp)
    if leaf in ("conv_b", "norm_z"):
        return spec(tp)

    # ---- rwkv6 --------------------------------------------------------------
    if parent in ("wr", "wk", "wv", "wg") and leaf == "w":
        return spec(dp, tp)
    if parent == "wo" and leaf == "w":
        return spec(tp, dp)
    if parent in ("w_lora_a",) and leaf == "w":
        return spec(dp, None)
    if parent in ("w_lora_b",) and leaf == "w":
        return spec(None, tp)
    if leaf == "mu":
        return spec(None, tp)

    # ---- everything else (norm scales, per-head vectors, scalars) ----------
    return spec(*([None] * len(core)))


def leaf_path(name: str) -> str:
    """The reference's leaf path of a parameter named ``name`` in
    ``Transformer.named_parameters()`` ("layers.3.attn.wq.w" ->
    "layers/attn/wq/w")."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "/".join(["layers"] + parts[2:])
    return "/".join(parts)


def param_specs(model: torch.nn.Module, cfg: ModelConfig, mesh,
                strat: ShardingStrategy = ShardingStrategy()) -> Dict[str, Spec]:
    """{leaf path: Spec} for every leaf of ``param_leaves(model)`` (a
    stacked leaf's one spec serves each of its layers' tensors); works on
    a model on the meta device too."""
    out: Dict[str, Spec] = {}
    for name, p in model.named_parameters():
        path = leaf_path(name)
        if path not in out:
            out[path] = _rule(path, tuple(p.shape), cfg, mesh, strat)
    return dict(sorted(out.items()))


def _dp_for(mesh, size: int):
    """dp axes if they divide ``size`` evenly, else the largest prefix that
    does (a batch of 1 — long_500k — simply replicates)."""
    sizes = axis_sizes(mesh)
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        if size % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes) if axes else None


def _tree_map(f, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(f, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(_tree_map(f, v, path + (str(i),)) for i, v in enumerate(tree))
    return f(path, tree)


def batch_specs(cfg: ModelConfig, mesh, batch: Any) -> Any:
    def f(path, leaf):
        nd = len(leaf.shape)
        dp = _dp_for(mesh, leaf.shape[0])
        if nd >= 3:  # embeds (B,S,D)
            return Spec(dp, None, None)
        return Spec(*((dp,) + (None,) * (nd - 1)))

    return _tree_map(f, batch)


def cache_specs(cfg: ModelConfig, mesh, cache: Any,
                strat: ShardingStrategy = ShardingStrategy()) -> Any:
    """Decode-cache shardings, per layer (the reference's rules without the
    stacked layer dimension).

    KV tensors (B,T,KVH,hd): kv-heads over ``model`` when divisible, else
    the cache SEQUENCE dim is sharded over ``model`` (flash-decoding
    style).  ``pos`` (an int here, a scalar array in the reference) is
    replicated."""
    tp_n = _tp_size(mesh)

    def f(path, leaf):
        leafname = path[-1]
        if leafname == "pos" or not isinstance(leaf, torch.Tensor):
            return Spec()
        shape = tuple(leaf.shape)
        dp = _dp_for(mesh, shape[0]) if len(shape) >= 1 else None
        if leafname in ("k", "v") and len(shape) == 4:
            kvh = shape[2]
            seq_shard = strat.seq_shard_cache
            if seq_shard is None:
                seq_shard = kvh % tp_n != 0
            if seq_shard:
                return Spec(dp, "model", None, None)
            return Spec(dp, None, "model", None)
        if leafname == "wkv" and len(shape) == 4:  # (B,h,hd,hd)
            if shape[1] % tp_n == 0:
                return Spec(dp, "model", None, None)
            return Spec(dp, None, None, None)
        if leafname == "ssm" and len(shape) == 4:  # (B,nh,hd,N)
            return Spec(dp, None, None, None)
        if leafname == "conv" and len(shape) == 3:  # (B,dc-1,d_in)
            return Spec(dp, None, "model")
        if len(shape) >= 1:  # shifts (B,D) etc.
            return Spec(*((dp,) + (None,) * (len(shape) - 1)))
        return Spec()

    return _tree_map(f, cache)


def logits_spec(mesh) -> Spec:
    return Spec(dp_axes(mesh), None, "model")


def named(mesh, specs: Any) -> Any:
    """A tree of specs as a congruent tree of placements."""
    return _tree_map(lambda _, s: placements(mesh, s), specs)


def local_shape(shape: Sequence[int], mesh, spec: Sequence) -> Tuple[int, ...]:
    """Rank 0's shard shape (the largest: ``torch.chunk`` gives the first
    ranks the full chunks) of a tensor of ``shape`` placed by ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, a in enumerate(spec):
        if a is None:
            continue
        for n in ((a,) if isinstance(a, str) else a):
            if n in sizes:
                out[d] = min(out[d], -(-out[d] // sizes[n]))
    return tuple(out)


def _distribute_tensor(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    # every rank holds the same full tensor: each keeps its shard, no sends
    return distribute_tensor(t, mesh, placements(mesh, spec), src_data_rank=None)


def distribute(tree: Any, specs: Any, mesh) -> Any:
    """``tree`` (dicts, lists and tuples of tensors; other leaves kept) with
    every tensor placed by the congruent spec of ``specs``."""
    def f(path, leaf):
        spec = specs
        for k in path:
            spec = spec[int(k) if isinstance(spec, (list, tuple)) and not isinstance(spec, Spec)
                        else k]
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return _distribute_tensor(leaf, mesh, spec)

    return _tree_map(f, tree)


def distribute_model(model: torch.nn.Module, cfg: ModelConfig, mesh,
                     strat: ShardingStrategy = ShardingStrategy()) -> torch.nn.Module:
    """Replace every parameter of ``model`` by a DTensor placed by
    :func:`param_specs`, in place (``requires_grad`` kept)."""
    specs = param_specs(model, cfg, mesh, strat)
    for name, p in list(model.named_parameters()):
        *owner, attr = name.split(".")
        mod = model.get_submodule(".".join(owner))
        dt = _distribute_tensor(p.detach(), mesh, specs[leaf_path(name)])
        setattr(mod, attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    return model
