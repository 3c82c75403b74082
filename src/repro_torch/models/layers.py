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
``dense`` here.  ``shard_hint`` is the reference's sharding constraint:
under an ambient ``DeviceMesh`` (``ambient_mesh``, which the sharded step
factories set) it redistributes a DTensor to the hinted placements, and
elsewhere it is the identity.  Parameters are made from an explicit
``torch.Generator`` with the reference's distributions (not its numbers:
``jax.random`` bits differ; ``models.convert`` copies them instead).
``cross_entropy`` is the training loss's token term.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Iterator, List, Optional

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
    "model_device",
    "cross_entropy",
    "shard_hint",
    "split_heads",
    "head_layout",
    "ambient_mesh",
    "current_mesh",
    "placements",
    "DP",
]

DP = ("pod", "data")  # data-parallel axes (filtered by shard_hint)

_MESH: List = [None]


def current_mesh():
    """The ambient ``DeviceMesh`` (None outside ``ambient_mesh``)."""
    return _MESH[-1]


@contextmanager
def ambient_mesh(mesh) -> Iterator:
    """Make ``mesh`` ambient for the block: ``shard_hint`` constrains
    against it and ``moe_ffn`` may take its expert-parallel column."""
    _MESH.append(mesh)
    try:
        yield mesh
    finally:
        _MESH.pop()


def _dividing(mesh, shape, axes):
    """``axes`` with each dimension's names cut to the longest prefix whose
    sizes divide it (a batch of 1 replicates): DTensor does not pad an
    uneven dimension as GSPMD does, and per-rank code over one (``local_map``)
    would read its global size wrongly."""
    names = tuple(mesh.mesh_dim_names)
    out = []
    for n, a in zip(shape, axes):
        if a is None:
            out.append(None)
            continue
        keep, prod = [], 1
        for name in ((a,) if isinstance(a, str) else a):
            if name not in names:
                continue
            size = mesh.size(names.index(name))
            if n % (prod * size):
                break
            keep.append(name)
            prod *= size
        out.append(tuple(keep) or None)
    return out


def placements(mesh, spec) -> tuple:
    """DTensor placements (one per mesh dimension) of ``spec`` (per tensor
    dimension an axis name, a tuple of names, or None); axis names the mesh
    lacks are dropped, and an axis of size 1 replicates (its one shard is
    the whole tensor, and DTensor's view rules then treat the dimension as
    whole).  ``launch.shardings`` places its specs by it."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    out = [Replicate()] * len(names)
    for d, a in enumerate(spec):
        if a is None:
            continue
        for n in ((a,) if isinstance(a, str) else a):
            if n not in names or sizes[n] == 1:  # one shard is the whole
                continue
            i = names.index(n)
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {n!r} shards two dimensions")
            out[i] = Shard(d)
    return tuple(out)


def shard_hint(x: torch.Tensor, *axes) -> torch.Tensor:
    """Best-effort sharding constraint against the ambient mesh.

    ``axes`` give per-dimension mesh axis names (str, tuple of str, or
    None); names absent from the ambient mesh are dropped, and so are
    names past those whose sizes divide the dimension.  With no
    ambient mesh, or on a plain tensor, this is the identity; on a DTensor
    it redistributes to the hinted placements (pending partial sums are
    reduced there), so model code carries its sharding contract without
    depending on the launcher.  Critical use: the logits constraint keeps
    the (B, S, vocab) tensor vocab-sharded instead of replicated."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = placements(mesh, _dividing(mesh, x.shape, axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


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


def model_device(device: Device) -> torch.device:
    """``device`` (the card by default; raises without one), or the ``meta``
    device, on which a builder makes shapes and dtypes only (the dry run's
    and ``configs.input_specs``' stand-ins)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return _device(device)


def init_device(gen: torch.Generator, device: Device) -> torch.device:
    """``device`` (the card by default; raises without one), which ``gen``
    must draw on (any generator for the ``meta`` device)."""
    dev = model_device(device)
    if dev.type != "meta" and gen.device.type != dev.type:
        raise ValueError(f"a generator on {gen.device} cannot draw tensors for {dev}")
    return dev


def init_norm(d: int, device: Device = None) -> RMSNorm:
    return RMSNorm(torch.ones((d,), dtype=torch.float32, device=model_device(device)))


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


def _dt_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of a DTensor activation and a DTensor (d_in, d_out) weight,
    with the Megatron/FSDP layout made explicit, mesh dimension by mesh
    dimension: a dp axis gathers the weight (FSDP) and keeps the batch
    sharded; a column-parallel weight (``Shard(1)`` over ``model``) takes a
    whole input and gives output columns; a row-parallel one (``Shard(0)``)
    takes input columns and gives partial sums.  The backward reduces the
    input's gradient over the columns' ranks and the weight's over the
    batch's (declared partial), so the gradients land as the reference's
    GSPMD program has them.  DTensor's own choice for a product may shard
    the sequence instead, which its later reshapes cannot express."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = w.device_mesh
    last = x.dim() - 1
    x_pl, w_pl, y_pl, xg_pl, wg_pl = [], [], [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        wp, xp, n = w.placements[i], x.placements[i], mesh.size(i)
        if name in DP or n == 1 or not wp.is_shard() or w.shape[wp.dim] % n:
            # the weight gathered (FSDP; or split unevenly), the batch kept
            xi = Shard(0) if xp == Shard(0) else Replicate()
            x_pl.append(xi), w_pl.append(Replicate()), y_pl.append(xi), xg_pl.append(xi)
            wg_pl.append(Partial() if xi == Shard(0) else Replicate())
        elif wp == Shard(1):  # column parallel
            x_pl.append(Replicate()), w_pl.append(wp), y_pl.append(Shard(last))
            xg_pl.append(Partial()), wg_pl.append(wp)
        else:  # row parallel
            x_pl.append(Shard(last)), w_pl.append(wp), y_pl.append(Partial())
            xg_pl.append(Shard(last)), wg_pl.append(wp)
    f = local_map(torch.matmul, out_placements=(tuple(y_pl),),
                  in_placements=(tuple(x_pl), tuple(w_pl)),
                  in_grad_placements=(tuple(xg_pl), tuple(wg_pl)),
                  redistribute_inputs=True, device_mesh=mesh)
    return f(x, w)


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)``; a mixed product is promoted as JAX does (bf16 x f32
    -> f32)."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and isinstance(w, DTensor):
        y = _dt_linear(x, w)
        return y if b is None else y + b
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


def _vocab_shards(logits: torch.Tensor):
    """The mesh dimensions of size > 1 that shard a DTensor's last (vocab)
    dimension (none for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(logits, DTensor):
        return []
    last = logits.dim() - 1
    return [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == last and logits.device_mesh.size(i) > 1]


def _vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, dims) -> torch.Tensor:
    """Cross-entropy of vocab-sharded float32 logits without gathering the
    vocab: a max and a sum of exponentials reduced over the vocab shards,
    and the label's logit taken by the one shard that holds it (a partial
    sum over them, reduced like the rest)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    if len(dims) != 1:
        raise NotImplementedError("a vocab dimension sharded over several mesh axes")
    (vdim,) = dims
    v_total = logits.shape[-1]
    chunk = -(-v_total // mesh.size(vdim))
    v0 = mesh.get_local_rank(vdim) * chunk  # this rank's first vocab id
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = m.redistribute(mesh, [Replicate() if i == vdim else p
                              for i, p in enumerate(m.placements)])
    tok_pl = tuple(Replicate() if i == vdim else p for i, p in enumerate(logits.placements))
    # the shards' sums reduced whole over the vocab ranks (DTensor would
    # reduce-scatter them by sequence, and hand the gradient back so)
    sums = torch.exp(logits - m).sum(dim=-1).redistribute(mesh, tok_pl)
    lse = torch.log(sums) + m[..., 0]
    labels = labels.to(torch.int64)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim)
    # the labels are laid out as the logits' leading dimensions
    lab_pl = [Replicate() if i == vdim else p for i, p in enumerate(logits.placements)]
    labels = labels.redistribute(mesh, lab_pl)

    def label_logit(lg, lab):
        idx = lab - v0
        hit = (idx >= 0) & (idx < lg.shape[-1])
        g = torch.gather(lg, -1, idx.clamp(0, max(lg.shape[-1] - 1, 0))[..., None])[..., 0]
        return torch.where(hit, g, torch.zeros_like(g))

    out_pl = [Partial() if i == vdim else p for i, p in enumerate(logits.placements)]
    ll = local_map(label_logit, out_placements=(tuple(out_pl),),
                   in_placements=(tuple(logits.placements), tuple(lab_pl)),
                   redistribute_inputs=False, device_mesh=mesh)(logits, labels)
    return torch.mean(lse - ll.redistribute(mesh, tok_pl))


def split_heads(y: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * hd) -> (B, S, heads, hd).  A DTensor whose columns are
    sharded over more ranks than divide the heads (4 KV heads over 16) is
    gathered on those mesh dimensions first: DTensor splits no head across
    ranks, where GSPMD pads."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(y, DTensor):
        mesh, last = y.device_mesh, y.dim() - 1
        pl = [Replicate() if (p.is_shard() and p.dim == last and heads % mesh.size(i))
              else p for i, p in enumerate(y.placements)]
        if pl != list(y.placements):
            y = y.redistribute(mesh, pl)
    b, s = y.shape[:2]
    return y.reshape(b, s, heads, head_dim)


def head_layout(mesh, batch_sharded, heads: int, head_dim: int):
    """Placements of a per-head tensor whose dimension ``head_dim`` holds
    ``heads`` heads, for per-rank code: dimension 0 over the mesh
    dimensions in ``batch_sharded`` (the batch), the heads over the other
    mesh dimensions of size > 1 when they divide the heads (else whole)."""
    from torch.distributed.tensor import Replicate, Shard

    shard = [i for i in range(mesh.ndim) if i not in batch_sharded and mesh.size(i) > 1]
    n = 1
    for i in shard:
        n *= mesh.size(i)
    if heads % n:
        shard = []
    return tuple(Shard(0) if i in batch_sharded else Shard(head_dim) if i in shard
                 else Replicate() for i in range(mesh.ndim))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32: logsumexp minus the label's
    logit.  logits (..., V), labels (...) ints.  Logits whose vocab is
    sharded (a DTensor under ``shard_hint``'s vocab constraint) take the
    vocab-parallel form; whole logits (a one-device mesh's too, so that it
    computes bit for bit what no mesh does) the plain formula."""
    logits = logits.to(torch.float32)
    dims = _vocab_shards(logits)
    if dims:
        return _vocab_parallel_ce(logits, labels, dims)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - ll)
