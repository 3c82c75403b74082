"""Shared neural building blocks: ``nn.Module``s that hold the parameters
and plain functions on tensors that apply them (the modules have no
``forward`` of their own).  The builders put their tensors on ``device``,
the card unless the caller asks for the CPU (``device="cpu"``); they raise
where there is no card, and draw from a generator on that device.

Counterpart of ``repro.models.layers``, with its layouts and casts: a
dense weight is (d_in, d_out) and applied as ``x @ w`` (the reference's
product order, so converting its parameters is a copy); ``rms_norm``
computes in float32 and casts back; ``rope`` rotates the two halves of the
head dim with float32 angles.  Where the reference multiplies a bfloat16
activation with a float32 weight, JAX promotes both to float32, and so does
``dense`` here.  The reference's ``shard_hint`` has no counterpart: the
port runs on one card.  Parameters are made from an explicit
``torch.Generator`` with the reference's distributions (not its numbers:
``jax.random`` bits differ; ``models.convert`` copies them instead).
``cross_entropy`` is the training loss's token term.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.ops.sort import Device, _device

__all__ = [
    "Dense",
    "RMSNorm",
    "SwiGLU",
    "GeluMLP",
    "rms_norm",
    "dense",
    "linear",
    "swiglu",
    "gelu_mlp",
    "rope",
    "init_dense",
    "init_norm",
    "frozen",
    "init_device",
    "cross_entropy",
]


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter made with ``requires_grad=False``: serving reads it and
    records no graph.  The trainer turns gradients on for its own model
    (``requires_grad_(True)`` on every parameter)."""
    return nn.Parameter(t, requires_grad=False)


class Dense(nn.Module):
    """``x @ w (+ b)`` with the reference's (d_in, d_out) weight."""

    def __init__(self, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        super().__init__()
        self.w = frozen(w)
        self.b = None if b is None else frozen(b)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = frozen(scale)


class SwiGLU(nn.Module):
    def __init__(self, gate: Dense, up: Dense, down: Dense):
        super().__init__()
        self.gate, self.up, self.down = gate, up, down


class GeluMLP(nn.Module):
    def __init__(self, up: Dense, down: Dense):
        super().__init__()
        self.up, self.down = up, down


def init_device(gen: torch.Generator, device: Device) -> torch.device:
    """``device`` (the card by default; raises without one), which ``gen``
    must draw on."""
    dev = _device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"a generator on {gen.device} cannot draw tensors for {dev}")
    return dev


def init_norm(d: int, device: Device = None) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=torch.float32, device=_device(device)))


def rms_norm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
               dtype=torch.bfloat16, device: Device = None) -> Dense:
    device = init_device(gen, device)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    w = (w * (1.0 / math.sqrt(d_in))).to(dtype)
    b = torch.zeros((d_out,), dtype=dtype, device=device) if bias else None
    return Dense(w, b)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``; a mixed product is promoted as JAX does (bf16 x f32
    -> f32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p.w, p.b)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = dense(p.gate, x)
    u = dense(p.up, x)
    return dense(p.down, F.silu(g) * u)


def gelu_mlp(p: GeluMLP, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return dense(p.down, F.gelu(dense(p.up, x), approximate="tanh"))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, hd); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(
        -math.log(theta) * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., s, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32: logsumexp minus the label's
    logit.  logits (..., V), labels (...) ints."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - ll)
