"""Mamba2 (SSD, state-space duality) mixer, chunked-scan formulation.

Counterpart of ``repro.models.ssm`` (``init_mamba2``, ``init_ssm_state``,
``mamba2``), the Mamba2 block of zamba2: an input projection to (x, z, B,
C, dt), a short causal depthwise conv on x, the selective state-space
recurrence with a scalar decay A per head, and the gated RMSNorm before
the output projection.  Prefill runs the chunked algorithm (``_ssd_chunked``,
chunk 128: the quadratic form within a chunk, a loop over chunks carrying
the (H, hd, N) float32 state); decode is the recurrence's closed form,
one step.  The conv state is stored in bfloat16, the SSM state in float32,
as in the reference; a sequence that is not a multiple of ``min(chunk, S)``
raises, as the reference does.

A given state dict is updated in place (``copy_`` into its tensors, in
their dtypes: a conv state made float32 by the caller stays float32);
without one (training) the forward is stateless and differentiable.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    Dense, dense, frozen, head_layout, init_dense, init_device, model_device, split_heads,
)
from repro_torch.ops.sort import Device

__all__ = ["Mamba2", "init_mamba2", "mamba2", "init_ssm_state"]

State = Dict[str, torch.Tensor]


class Mamba2(nn.Module):
    """``in_proj`` packs [x, z, B, C, dt]; ``conv_w`` (d_conv, d_in) and
    ``conv_b``; float32 ``A_log``, ``dt_bias`` and ``D`` per head;
    ``norm_z`` (d_in,) and ``out_proj``."""

    def __init__(self, in_proj: Dense, conv_w, conv_b, A_log, dt_bias, D, norm_z,
                 out_proj: Dense):
        super().__init__()
        self.in_proj, self.out_proj = in_proj, out_proj
        self.conv_w, self.conv_b = frozen(conv_w), frozen(conv_b)
        self.A_log, self.dt_bias, self.D = frozen(A_log), frozen(dt_bias), frozen(D)
        self.norm_z = frozen(norm_z)


def init_mamba2(gen: torch.Generator, d_model: int, *, d_state: int, d_conv: int,
                expand: int, head_dim: int, dtype=torch.bfloat16,
                device: Device = None) -> Mamba2:
    device = init_device(gen, device)
    d_in = expand * d_model
    nheads = d_in // head_dim
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = init_dense(gen, d_model, 2 * d_in + 2 * d_state + nheads, **kw)
    conv_w = (torch.randn((d_conv, d_in), generator=gen, **f32) / math.sqrt(d_conv)).to(dtype)
    out_proj = init_dense(gen, d_in, d_model, **kw)
    return Mamba2(in_proj, conv_w, torch.zeros((d_in,), **kw),
                  torch.zeros((nheads,), **f32),  # A = -exp(A_log) in (-inf, 0)
                  torch.full((nheads,), math.log(math.e - 1), **f32),
                  torch.ones((nheads,), **f32), torch.ones((d_in,), **kw), out_proj)


def init_ssm_state(batch: int, d_model: int, *, d_state: int, d_conv: int, expand: int,
                   head_dim: int, dtype=torch.float32, device: Device = None) -> State:
    device = model_device(device)
    d_in = expand * d_model
    nheads = d_in // head_dim
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_in), dtype=torch.bfloat16, device=device),
        "ssm": torch.zeros((batch, nheads, head_dim, d_state), dtype=dtype, device=device),
    }


def _split_proj(p: Mamba2, x: torch.Tensor, d_in: int, d_state: int):
    proj = dense(p.in_proj, x)
    xs, z = proj[..., :d_in], proj[..., d_in:2 * d_in]
    rest = proj[..., 2 * d_in:]
    return xs, z, rest[..., :d_state], rest[..., d_state:2 * d_state], rest[..., 2 * d_state:]


def _conv1d(p: Mamba2, xs: torch.Tensor, conv_state: Optional[torch.Tensor]):
    """The short causal depthwise conv over xs (B, S, d_in); returns (its
    silu'd output, the last d_conv - 1 inputs)."""
    d_conv = p.conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xs.shape[0], d_conv - 1, xs.shape[-1]), dtype=xs.dtype,
                          device=xs.device)
    else:
        pad = conv_state.to(xs.dtype)
    xp = torch.cat([pad, xs], dim=1)  # (B, S + dc - 1, d_in)
    s = xs.shape[1]
    out = sum(xp[:, i:i + s, :] * p.conv_w[i] for i in range(d_conv))
    new_state = xp[:, xp.shape[1] - (d_conv - 1):, :]
    return F.silu(out + p.conv_b), new_state


def _ssd_chunked(
    xh: torch.Tensor,      # (B, S, H, hd)
    dt: torch.Tensor,      # (B, S, H) softplus'd, f32
    A: torch.Tensor,       # (H,) negative, f32
    B_: torch.Tensor,      # (B, S, N)
    C_: torch.Tensor,      # (B, S, N)
    state0: torch.Tensor,  # (B, H, hd, N) f32
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan.  Returns (y (B, S, H, hd) f32, the final state)."""
    b, s, h, hd = xh.shape
    n = B_.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xc = xh.reshape(b, nc, chunk, h, hd).to(f32)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B_.reshape(b, nc, chunk, n).to(f32)
    Cc = C_.reshape(b, nc, chunk, n).to(f32)

    cum = torch.cumsum(dtc * A, dim=2)              # (b, nc, c, h), inclusive
    # within a chunk: y_i += C_i . sum_{j<=i} exp(cum_i - cum_j) dt_j B_j x_j
    # the mask goes in before the exp: above the diagonal cum_i - cum_j > 0
    # can overflow to inf, and where(mask, inf, 0) passes 0 * inf = NaN back
    # to the exp under autograd (the forward is the reference's exactly)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    gate = torch.exp(torch.where(causal[None, None, :, :, None],
                                 cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                 float("-inf")))  # (b, nc, c, c, h)
    cb = torch.einsum("bzin,bzjn->bzij", Cc, Bc)    # (b, nc, c, c)
    xdt = xc * dtc[..., None]                       # (b, nc, c, h, hd)
    y_intra = torch.einsum("bzijh,bzjhd->bzihd", cb[..., None] * gate, xdt)

    # each chunk's state contribution and total decay
    g_end = torch.exp(cum[:, :, -1:, :] - cum)      # (b, nc, c, h)
    dS = torch.einsum("bzch,bzchd,bzcn->bzhdn", g_end, xdt, Bc)
    decay_chunk = torch.exp(cum[:, :, -1, :])       # (b, nc, h)
    g_in = torch.exp(cum)                           # decay from the chunk's start to i

    st = state0
    y_inter = []
    for z in range(nc):  # the output of chunk z reads the INCOMING state
        y_inter.append(torch.einsum("bcn,bhdn,bch->bchd", Cc[:, z], st, g_in[:, z]))
        st = st * decay_chunk[:, z, :, None, None] + dS[:, z]
    y = y_intra + torch.stack(y_inter, dim=1)
    return y.reshape(b, s, h, hd), st


def _scan_local(xh, dtp, A, B_, C_, state0, chunk: int, step: bool):
    """The SSD scan on plain tensors: the decode step's closed form for one
    token against a state (``step``), else the chunked scan."""
    if step and xh.shape[1] == 1:
        dA = torch.exp(dtp[:, 0, :] * A)                    # (B, H)
        dBx = torch.einsum("bh,bhd,bn->bhdn", dtp[:, 0], xh[:, 0].to(torch.float32),
                           B_[:, 0].to(torch.float32))
        stateF = state0 * dA[:, :, None, None] + dBx
        y = torch.einsum("bhdn,bn->bhd", stateF, C_[:, 0].to(torch.float32))[:, None]
        return y, stateF
    return _ssd_chunked(xh, dtp, A, B_, C_, state0, chunk)


def _scan(xh, dtp, A, B_, C_, state0, chunk: int, step: bool):
    """``_scan_local``, on DTensors as per-rank code over the heads (each
    head's scan is its own; B and C are shared by all heads, so their
    gradients sum over the head shards), the batch over the dp axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    if not isinstance(xh, DTensor):
        return _scan_local(xh, dtp, A, B_, C_, state0, chunk, step)
    from torch.distributed.tensor.experimental import local_map

    mesh = xh.device_mesh
    h = xh.shape[2]
    batch = [i for i, pl in enumerate(xh.placements) if pl == Shard(0)]
    seq = head_layout(mesh, batch, h, 2)            # (B, S, H, hd)
    per_t = head_layout(mesh, batch, h, 2)          # (B, S, H): heads at dim 2 too
    heads = tuple(Replicate() if pl == Shard(0) else Shard(0) if pl.is_shard() else pl
                  for pl in seq)                    # (H,)
    heads_grad = tuple(Partial() if pl == Shard(0) else Shard(0) if pl.is_shard() else pl
                       for pl in seq)
    shared = tuple(Shard(0) if pl == Shard(0) else Replicate() for pl in seq)  # (B, S, N)
    shared_grad = tuple(Shard(0) if pl == Shard(0) else Partial() if pl.is_shard()
                        else Replicate() for pl in seq)
    state = head_layout(mesh, batch, h, 1)          # (B, H, hd, N)

    def dt(t):
        return t if isinstance(t, DTensor) else DTensor.from_local(
            t, mesh, [Replicate()] * mesh.ndim)

    f = local_map(lambda *a: _scan_local(*a, chunk, step), out_placements=(seq, state),
                  in_placements=(seq, per_t, heads, shared, shared, state),
                  in_grad_placements=(seq, per_t, heads_grad, shared_grad, shared_grad, state),
                  redistribute_inputs=True, device_mesh=mesh)
    return f(*(dt(t) for t in (xh, dtp, A, B_, C_, state0)))


def mamba2(p: Mamba2, x: torch.Tensor, *, d_state: int, expand: int, head_dim: int,
           chunk: int = 128, state: Optional[State] = None) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D).  With ``state`` the conv and the scan start
    from it (S == 1: the decode step's closed form) and it is updated in
    place."""
    b, s, d_model = x.shape
    d_in = expand * d_model
    nheads = d_in // head_dim
    xs, z, B_, C_, dt = _split_proj(p, x, d_in, d_state)
    xs, new_conv = _conv1d(p, xs, state["conv"] if state is not None else None)

    A = -torch.exp(p.A_log)
    dtp = F.softplus(dt.to(torch.float32) + p.dt_bias)  # (B, S, H)
    xh = split_heads(xs, nheads, head_dim)
    state0 = (state["ssm"] if state is not None
              else torch.zeros((b, nheads, head_dim, d_state), dtype=torch.float32,
                               device=x.device))
    if s % min(chunk, s):
        raise ValueError(f"seq {s} not divisible by chunk {min(chunk, s)}")
    y, stateF = _scan(xh, dtp, A, B_, C_, state0, min(chunk, s), state is not None)

    y = y + xh.to(torch.float32) * p.D[:, None]
    y = y.reshape(b, s, d_in).to(x.dtype)
    # gated RMSNorm (Mamba2's norm before the output projection)
    yf = y.to(torch.float32) * F.silu(z.to(torch.float32))
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-5) * p.norm_z.to(torch.float32)
    out = dense(p.out_proj, yf.to(x.dtype))
    if state is not None:
        state["conv"].copy_(new_conv)  # rounds to the state's dtype, bf16 as in the reference
        state["ssm"].copy_(stateF)
    return out
