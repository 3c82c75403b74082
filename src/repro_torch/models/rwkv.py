"""RWKV-6 "Finch" mixer: time-mix with data-dependent decay + channel-mix.

Counterpart of ``repro.models.rwkv`` (``init_rwkv6``, ``init_rwkv_state``,
``rwkv6_timemix``, ``rwkv6_channelmix``), with its parameters and casts.
The per-head state is an (hd, hd) float32 outer-product accumulator with a
data-dependent per-channel decay ``w = exp(-exp(bias + lora(x)))`` in
float32.  Prefill runs the recurrence as a loop over the sequence (the
reference's ``lax.scan``); decode is its closed form, one step.  The
token-shift states ``tm_shift`` and ``cm_shift`` are kept in bfloat16
whatever the model's dtype, and the per-head group norm uses eps 64e-5, as
in the reference.

A given state dict is updated in place (``copy_`` into its tensors), the
port's form of the reference's returned state; without one (training) the
forward is stateless and differentiable.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    Dense, dense, frozen, head_layout, init_dense, init_device, model_device, split_heads,
)
from repro_torch.ops.sort import Device

__all__ = ["TimeMix", "ChannelMix", "RWKV6", "init_rwkv6", "rwkv6_timemix",
           "rwkv6_channelmix", "init_rwkv_state"]

State = Dict[str, torch.Tensor]


class TimeMix(nn.Module):
    """``mu`` (5, D) shift-lerps for r, k, v, w, g; ``wr``..``wo``; the decay
    LoRA ``w_lora_a``/``w_lora_b`` with a float32 ``w_bias``; the float32
    ``bonus`` (h, hd) and group-norm scale ``ln_x``."""

    def __init__(self, mu, wr: Dense, wk: Dense, wv: Dense, wg: Dense, wo: Dense,
                 w_lora_a: Dense, w_lora_b: Dense, w_bias, bonus, ln_x):
        super().__init__()
        self.mu = frozen(mu)
        self.wr, self.wk, self.wv, self.wg, self.wo = wr, wk, wv, wg, wo
        self.w_lora_a, self.w_lora_b = w_lora_a, w_lora_b
        self.w_bias, self.bonus, self.ln_x = frozen(w_bias), frozen(bonus), frozen(ln_x)


class ChannelMix(nn.Module):
    """``mu`` (2, D) shift-lerps for k, r; ``wk`` (D, d_ff), ``wv``, ``wr``."""

    def __init__(self, mu, wk: Dense, wv: Dense, wr: Dense):
        super().__init__()
        self.mu = frozen(mu)
        self.wk, self.wv, self.wr = wk, wv, wr


class RWKV6(nn.Module):
    def __init__(self, tm: TimeMix, cm: ChannelMix):
        super().__init__()
        self.tm, self.cm = tm, cm


def init_rwkv6(gen: torch.Generator, d_model: int, *, head_dim: int, d_ff: int,
               lora: int = 64, dtype=torch.bfloat16, device: Device = None) -> RWKV6:
    device = init_device(gen, device)
    h = d_model // head_dim
    kw = dict(dtype=dtype, device=device)

    def dn(d_in, d_out):
        return init_dense(gen, d_in, d_out, **kw)

    f32 = dict(dtype=torch.float32, device=device)
    tm = TimeMix(
        torch.full((5, d_model), 0.5, **kw),
        dn(d_model, d_model), dn(d_model, d_model), dn(d_model, d_model),
        dn(d_model, d_model), dn(d_model, d_model), dn(d_model, lora), dn(lora, d_model),
        torch.full((d_model,), -2.0, **f32),
        torch.randn((h, head_dim), generator=gen, **f32) * 0.1,
        torch.ones((d_model,), **f32),
    )
    cm = ChannelMix(torch.full((2, d_model), 0.5, **kw), dn(d_model, d_ff), dn(d_ff, d_model),
                    dn(d_model, d_model))
    return RWKV6(tm, cm)


def init_rwkv_state(batch: int, d_model: int, *, head_dim: int, dtype=torch.float32,
                    device: Device = None) -> State:
    device = model_device(device)
    h = d_model // head_dim
    return {
        "tm_shift": torch.zeros((batch, d_model), dtype=torch.bfloat16, device=device),
        "cm_shift": torch.zeros((batch, d_model), dtype=torch.bfloat16, device=device),
        "wkv": torch.zeros((batch, h, head_dim, head_dim), dtype=dtype, device=device),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along seq; position 0 gets ``prev`` (or zeros)."""
    b, s, d = x.shape
    first = (prev[:, None, :].to(x.dtype) if prev is not None
             else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device))
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _wkv_local(rf, kf, vf, w, u, st):
    ys = []
    for t in range(rf.shape[1]):  # s == 1 with a state is the decode step, closed form
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (b, h, hd, hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], st + u * kv))
        st = st * w[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), st


def _wkv(rf, kf, vf, w, u, st):
    """The WKV recurrence over (B, S, h, hd) inputs from state ``st`` (B, h,
    hd, hd): (outputs, the final state).  On DTensors it runs as per-rank
    code over the heads (each head's recurrence is its own), the batch over
    the dp axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(rf, DTensor):
        return _wkv_local(rf, kf, vf, w, u, st)
    from torch.distributed.tensor.experimental import local_map

    mesh = rf.device_mesh
    h = rf.shape[2]
    batch = [i for i, p in enumerate(rf.placements) if p == Shard(0)]
    seq = head_layout(mesh, batch, h, 2)        # (B, S, h, hd)
    state = head_layout(mesh, batch, h, 1)      # (B, h, hd, hd)
    bonus = tuple(Replicate() if p == Shard(0) else p for p in state)   # (1, h, hd, 1)
    bonus_grad = tuple(Partial() if p == Shard(0) else p for p in state)
    st = st if isinstance(st, DTensor) else DTensor.from_local(
        st, mesh, [Replicate()] * mesh.ndim)
    u = u if isinstance(u, DTensor) else DTensor.from_local(u, mesh, [Replicate()] * mesh.ndim)
    f = local_map(_wkv_local, out_placements=(seq, state),
                  in_placements=(seq, seq, seq, seq, bonus, state),
                  in_grad_placements=(seq, seq, seq, seq, bonus_grad, state),
                  redistribute_inputs=True, device_mesh=mesh)
    return f(rf, kf, vf, w, u, st)


def rwkv6_timemix(p: RWKV6, x: torch.Tensor, *, head_dim: int,
                  state: Optional[State] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D).  With ``state`` the recurrence starts from
    it and it is updated in place: ``tm_shift`` (bf16) and ``wkv``."""
    tm = p.tm
    b, s, d = x.shape
    h = d // head_dim
    prev = state["tm_shift"] if state is not None else None
    xp = _shift(x, prev)
    mu = tm.mu.to(x.dtype)

    def lerp(i):
        return x + (xp - x) * mu[i]

    r = split_heads(dense(tm.wr, lerp(0)), h, head_dim)
    k = split_heads(dense(tm.wk, lerp(1)), h, head_dim)
    v = split_heads(dense(tm.wv, lerp(2)), h, head_dim)
    # data-dependent decay (Finch): w = exp(-exp(bias + lora(x_lerped)))
    wlog = dense(tm.w_lora_b, torch.tanh(dense(tm.w_lora_a, lerp(3))))
    wlog = tm.w_bias + wlog.to(torch.float32)
    w = split_heads(torch.exp(-torch.exp(wlog)), h, head_dim)  # in (0, 1)
    g = F.silu(dense(tm.wg, lerp(4)))

    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    u = tm.bonus[None, :, :, None]  # (1, h, hd, 1)
    st = (state["wkv"] if state is not None
          else torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32, device=x.device))
    out, st = _wkv(rf, kf, vf, w, u, st)  # (B, S, h, hd)

    # group norm per head, then the output gate and projection
    mean = out.mean(dim=-1, keepdim=True)
    var = out.var(dim=-1, unbiased=False, keepdim=True)
    of = (out - mean) * torch.rsqrt(var + 64e-5)
    of = of.reshape(b, s, d) * tm.ln_x
    y = dense(tm.wo, of.to(x.dtype) * g)
    if state is not None:
        state["tm_shift"].copy_(x[:, -1, :])  # in the state's dtype, bf16 as the reference
        state["wkv"].copy_(st)
    return y


def rwkv6_channelmix(p: RWKV6, x: torch.Tensor, *, state: Optional[State] = None
                     ) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); a given state's ``cm_shift`` is updated in
    place."""
    cm = p.cm
    prev = state["cm_shift"] if state is not None else None
    xp = _shift(x, prev)
    mu = cm.mu.to(x.dtype)
    xk = x + (xp - x) * mu[0]
    xr = x + (xp - x) * mu[1]
    k = torch.square(F.relu(dense(cm.wk, xk)))
    y = torch.sigmoid(dense(cm.wr, xr)) * dense(cm.wv, k)
    if state is not None:
        state["cm_shift"].copy_(x[:, -1, :])
    return y
