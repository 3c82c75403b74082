"""The reference's parameters as the port's modules.

``params_from_jax(tree, cfg, device, dtype)`` takes the parameter pytree of
``repro.models.transformer.init_model`` with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``; bfloat16 leaves come as numpy's
``bfloat16`` extension dtype), unstacks the leading layer axis into one
block per layer and copies every weight, so that both packages compute
with the same numbers.  The layouts are the same: dense weights are
(d_in, d_out) in both; MoE experts are stacked (E, D, F) / (E, F, D) in
both.  The trees by family: attention layers ``layers.{ln1, attn, ln2,
mlp}`` (``mlp`` a SwiGLU, a GELU MLP, or ``router``/``experts``/``shared``
for MoE); RWKV layers ``layers.{ln1, mix.tm.*, mix.cm.*, ln2}``; hybrid
layers ``layers.{ln1, mamba.*, ln2, mlp}`` with one ``shared_attn``.

``train_state_from_jax(state, cfg, device)`` carries a whole training
state of the reference's trainer across (``{"params", "opt", "eff"}``,
numpy leaves): the parameters as above, and the optimizer's trees keyed
like ``models.transformer.param_leaves``: the moments ``m`` and ``v`` in
their tiers (float32, bfloat16, or int8 ``{"q", "scale"}``, a stacked
``q`` split into its layers under the one scale), the step counter, and
the error feedback ``eff``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import Dense, GeluMLP, RMSNorm, SwiGLU
from repro_torch.models.moe import MoE, Experts
from repro_torch.models.rwkv import RWKV6, ChannelMix, TimeMix
from repro_torch.models.ssm import Mamba2
from repro_torch.models.transformer import (
    Block, MambaBlock, RwkvBlock, Transformer, _block_family,
)
from repro_torch.ops.sort import Device, _device

__all__ = ["params_from_jax", "to_torch", "leaves_from_jax", "train_state_from_jax"]


def to_torch(a: Any, device: Device = "cpu", dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One numpy array (bfloat16 included) as a tensor on ``device``."""
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # numpy's extension type: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, device: Device = None,
                    dtype: Optional[torch.dtype] = None) -> Transformer:
    """The reference's parameters (numpy leaves, stacked layers) as a
    ``Transformer`` on ``device``.  ``dtype`` casts the weights, embedding
    and biases; the leaves the reference keeps in float32 (norm scales, the
    MoE router, RWKV's decay bias, bonus and ``ln_x``, Mamba2's ``A_log``,
    ``dt_bias`` and ``D``) stay float32."""
    dev = _device(device)

    def w(a):
        return to_torch(a, dev, dtype)

    def f32(a):
        return to_torch(a, dev, torch.float32)

    def at(i):
        return (lambda a: a) if i is None else (lambda a: a[i])

    def dense(p, i=None, cast=w):
        pick = at(i)
        return Dense(cast(pick(p["w"])), cast(pick(p["b"])) if "b" in p else None)

    def norm(p, i=None):
        return RMSNorm(f32(at(i)(p["scale"])))

    def swiglu(m, i=None):
        return SwiGLU(dense(m["gate"], i), dense(m["up"], i), dense(m["down"], i))

    def mlp(m, i):
        if cfg.family == "moe":
            pick = at(i)
            e = m["experts"]
            experts = Experts(w(pick(e["gate"])), w(pick(e["up"])), w(pick(e["down"])))
            shared = swiglu(m["shared"], i) if "shared" in m else None
            return MoE(dense(m["router"], i, cast=f32), experts, shared)
        if cfg.family == "audio":
            return GeluMLP(dense(m["up"], i), dense(m["down"], i))
        return swiglu(m, i)

    def attn_block(lt, i=None):
        a = lt["attn"]
        attn = Attention(dense(a["wq"], i), dense(a["wk"], i), dense(a["wv"], i),
                         dense(a["wo"], i))
        return Block(norm(lt["ln1"], i), attn, norm(lt["ln2"], i), mlp(lt["mlp"], i))

    def rwkv_block(lt, i):
        pick = at(i)
        tm, cm = lt["mix"]["tm"], lt["mix"]["cm"]
        mix = RWKV6(
            TimeMix(w(pick(tm["mu"])), *(dense(tm[n], i) for n in
                                         ("wr", "wk", "wv", "wg", "wo", "w_lora_a", "w_lora_b")),
                    f32(pick(tm["w_bias"])), f32(pick(tm["bonus"])), f32(pick(tm["ln_x"]))),
            ChannelMix(w(pick(cm["mu"])), dense(cm["wk"], i), dense(cm["wv"], i),
                       dense(cm["wr"], i)))
        return RwkvBlock(norm(lt["ln1"], i), mix, norm(lt["ln2"], i))

    def mamba_block(lt, i):
        pick = at(i)
        m = lt["mamba"]
        mamba = Mamba2(dense(m["in_proj"], i), w(pick(m["conv_w"])), w(pick(m["conv_b"])),
                       f32(pick(m["A_log"])), f32(pick(m["dt_bias"])), f32(pick(m["D"])),
                       w(pick(m["norm_z"])), dense(m["out_proj"], i))
        return MambaBlock(norm(lt["ln1"], i), mamba, norm(lt["ln2"], i), swiglu(lt["mlp"], i))

    fam = _block_family(cfg)
    make = {"attn": attn_block, "rwkv": rwkv_block, "hybrid": mamba_block}[fam]
    layers = [make(tree["layers"], i) for i in range(cfg.num_layers)]
    return Transformer(
        layers, norm(tree["final_norm"]),
        embed=w(tree["embed"]) if "embed" in tree else None,
        lm_head=dense(tree["lm_head"]) if "lm_head" in tree else None,
        shared_attn=attn_block(tree["shared_attn"]) if fam == "hybrid" else None,
    )


def _is_q(node: Any) -> bool:
    return isinstance(node, Mapping) and set(node) == {"q", "scale"}


def leaves_from_jax(tree: Mapping[str, Any], device: Device = None) -> Dict[str, Any]:
    """A parameter-shaped tree of the reference (parameters, gradients, a
    moment tree, the error feedback; numpy leaves) keyed like
    ``models.transformer.param_leaves``: a leaf under ``layers`` (stacked
    over layers) becomes the tuple of its layers' tensors, and an int8
    ``{"q", "scale"}`` leaf keeps its one scale.  Leaves keep their dtypes."""
    dev = _device(device)
    out: Dict[str, Any] = {}

    def split(a, stacked):
        t = to_torch(a, dev)
        return tuple(x.clone() for x in t.unbind(0)) if stacked else t

    def walk(node, path):
        if isinstance(node, Mapping) and not _is_q(node):
            for k in sorted(node):
                walk(node[k], path + [k])
            return
        stacked = path[0] == "layers"
        name = "/".join(path)
        if _is_q(node):
            out[name] = {"q": split(node["q"], stacked), "scale": to_torch(node["scale"], dev)}
        else:
            out[name] = split(node, stacked)

    walk(tree, [])
    return out


def train_state_from_jax(state: Mapping[str, Any], cfg: ModelConfig,
                         device: Device = None) -> Dict[str, Any]:
    """The reference trainer's state (numpy leaves) as the port trainer's:
    ``{"params": Transformer, "opt": {"m", "v", "step"}, "eff"?}``.  The
    parameters keep their dtypes."""
    dev = _device(device)
    opt = state["opt"]
    out = {
        "params": params_from_jax(state["params"], cfg, device=dev),
        "opt": {"m": leaves_from_jax(opt["m"], dev), "v": leaves_from_jax(opt["v"], dev),
                "step": to_torch(opt["step"], dev, torch.int32)},
    }
    if "eff" in state:
        out["eff"] = leaves_from_jax(state["eff"], dev)
    return out
