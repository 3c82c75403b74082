"""The reference's parameters as the port's modules.

``params_from_jax(tree, cfg, device, dtype)`` takes the parameter pytree of
``repro.models.transformer.init_model`` with its leaves as numpy arrays
(``jax.tree.map(np.asarray, params)``; bfloat16 leaves come as numpy's
``bfloat16`` extension dtype), unstacks the leading layer axis into one
``Block`` per layer and copies every weight, so that both packages compute
with the same numbers.  The layouts are the same: dense weights are
(d_in, d_out) in both.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import Attention
from repro_torch.models.layers import Dense, GeluMLP, RMSNorm, SwiGLU
from repro_torch.models.transformer import Block, Transformer, _check_family
from repro_torch.ops.sort import Device, _device

__all__ = ["params_from_jax", "to_torch"]


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
    and biases; the norm scales stay float32, as the reference keeps them."""
    _check_family(cfg)
    dev = _device(device)

    def w(a):
        return to_torch(a, dev, dtype)

    def dense(p, i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        return Dense(w(pick(p["w"])), w(pick(p["b"])) if "b" in p else None)

    def norm(p, i=None):
        scale = p["scale"] if i is None else p["scale"][i]
        return RMSNorm(to_torch(scale, dev, torch.float32))

    lt = tree["layers"]
    layers = []
    for i in range(cfg.num_layers):
        a = lt["attn"]
        attn = Attention(dense(a["wq"], i), dense(a["wk"], i), dense(a["wv"], i),
                         dense(a["wo"], i))
        m = lt["mlp"]
        if cfg.family == "audio":
            mlp = GeluMLP(dense(m["up"], i), dense(m["down"], i))
        else:
            mlp = SwiGLU(dense(m["gate"], i), dense(m["up"], i), dense(m["down"], i))
        layers.append(Block(norm(lt["ln1"], i), attn, norm(lt["ln2"], i), mlp))
    return Transformer(
        layers, norm(tree["final_norm"]),
        embed=w(tree["embed"]) if "embed" in tree else None,
        lm_head=dense(tree["lm_head"]) if "lm_head" in tree else None,
    )
