"""AdamW with configurable moment dtypes (memory-tiered optimizer states).

Counterpart of ``repro.optim.adamw``: ``AdamWConfig``, ``adamw_init`` and
``adamw_update`` with the three moment tiers, ``float32``, ``bfloat16``
and int8 ``{"q", "scale"}`` (a per-leaf float32 scale, ``max |x| / 127``,
and ``q = clip(round(x / scale), -127, 127)``; ``torch.round`` rounds
half to even like ``jnp.round``).

``params`` is a dict from a leaf's name to a tensor or to a tuple of
tensors (``models.transformer.param_leaves``): a tuple is one leaf of
the reference that it stacks over layers, held as its layers' tensors.
Such a leaf counts as the reference counts its stacked array: one int8
scale over all its tensors, and decoupled weight decay because its stacked
ndim (one more than a layer's) is at least 2.  A tensor leaf decays when
its own ndim is at least 2.  ``grads`` has the structure of ``params``.

The update is elementwise per leaf in float32: the global-norm clip, bias
correction and the step's learning rate are float32 0-d tensors on the
parameters' device (no host read), and the parameters and the moments are
written back in place under ``torch.no_grad()``.  DTensor parameters (the
sharded train step's) get moments of their placements, a replicated int8
scale and step; the int8 scale's max over a sharded leaf is reduced over
its shards (DTensor's max all-reduce), so the codes equal the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Mapping, Sequence, Tuple, Union

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

Leaf = Union[torch.Tensor, Tuple[torch.Tensor, ...]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4              # peak; schedule multiplies
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    m_dtype: str = "float32"      # float32 | bfloat16 | int8
    v_dtype: str = "float32"      # float32 | bfloat16 | int8


def _parts(leaf: Leaf) -> Sequence[torch.Tensor]:
    return leaf if isinstance(leaf, tuple) else (leaf,)


def _like(leaf: Leaf, parts) -> Leaf:
    """``parts`` (one tensor per part of ``leaf``) in ``leaf``'s form."""
    return tuple(parts) if isinstance(leaf, tuple) else parts[0]


def _quantize(xs: Sequence[torch.Tensor]) -> Tuple[list, torch.Tensor]:
    """int8 codes of float32 tensors under one scale: (q per tensor, scale)."""
    amax = torch.stack([x.abs().max() for x in xs]).max()
    scale = torch.clamp(amax / 127.0, min=1e-12)
    return [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8) for x in xs], scale


def scalar_like(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A 0-d zero of ``dtype`` where ``t`` lies: replicated over ``t``'s
    mesh when ``t`` is a DTensor."""
    z = torch.zeros((), dtype=dtype, device=t.device)
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return DTensor.from_local(z, t.device_mesh, [Replicate()] * t.device_mesh.ndim)
    return z


def _q_init(p: Leaf, dtype: str):
    # zeros_like: a DTensor parameter's moments take its placements
    if dtype == "int8":
        return {"q": _like(p, [torch.zeros_like(t, dtype=torch.int8) for t in _parts(p)]),
                "scale": scalar_like(_parts(p)[0], torch.float32)}
    return _like(p, [torch.zeros_like(t, dtype=_DTYPES[dtype]) for t in _parts(p)])


def _q_read(s, dtype: str) -> list:
    if dtype == "int8":
        return [q.to(torch.float32) * s["scale"] for q in _parts(s["q"])]
    return [t.to(torch.float32) for t in _parts(s)]


def _q_write(s, xs: list, dtype: str) -> None:
    """Store a leaf's float32 moments ``xs`` into its state ``s`` in place."""
    if dtype == "int8":
        qs, scale = _quantize(xs)
        for dst, q in zip(_parts(s["q"]), qs):
            dst.copy_(q)
        s["scale"].copy_(scale)
        return
    for dst, x in zip(_parts(s), xs):
        dst.copy_(x)


def adamw_init(params: Mapping[str, Leaf], cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in the configured tiers, congruent to ``params``, and
    the int32 step counter."""
    first = _parts(next(iter(params.values())))[0]
    return {
        "m": {k: _q_init(p, cfg.m_dtype) for k, p in params.items()},
        "v": {k: _q_init(p, cfg.v_dtype) for k, p in params.items()},
        "step": scalar_like(first, torch.int32),
    }


def _global_norm(grads: Mapping[str, Leaf]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf, summed leaf by
    leaf in the tree's order."""
    def sq(t):
        return torch.sum(torch.square(t.to(torch.float32)))

    total = None
    for leaf in grads.values():
        # from the first part, not from 0: a DTensor's partial sums stay
        # partial (one reduction at the sqrt), and a leaf of L parts adds L - 1
        first, *rest = _parts(leaf)
        s = sq(first)
        for t in rest:
            s = s + sq(t)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(
    params: Mapping[str, Leaf],
    grads: Mapping[str, Leaf],
    state: Dict[str, Any],
    cfg: AdamWConfig,
    lr_scale: Union[torch.Tensor, float] = 1.0,
) -> Tuple[Mapping[str, Leaf], Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics) with
    ``grad_norm`` and ``lr`` (float32 0-d tensors)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=step.device), stepf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=step.device)

    for name, p in params.items():
        ps, gs = _parts(p), _parts(grads[name])
        decay = (len(ps[0].shape) + isinstance(p, tuple)) >= 2
        new_m, new_v = [], []
        for t, g, m, v in zip(ps, gs, _q_read(state["m"][name], cfg.m_dtype),
                              _q_read(state["v"][name], cfg.v_dtype)):
            g = g.to(torch.float32) * clip
            m = m * cfg.b1 + (1 - cfg.b1) * g
            v = v * cfg.b2 + (1 - cfg.b2) * g * g
            update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if decay:  # decoupled weight decay on matrices only
                update = update + cfg.weight_decay * t.to(torch.float32)
            t.copy_(t.to(torch.float32) - lr * update)
            new_m.append(m)
            new_v.append(v)
        # an int8 moment's one scale spans all of the leaf's parts
        _q_write(state["m"][name], new_m, cfg.m_dtype)
        _q_write(state["v"][name], new_v, cfg.v_dtype)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
