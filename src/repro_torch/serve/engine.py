"""Batched serving engine: prefill, then greedy or temperature decoding.

Counterpart of ``repro.serve.engine``'s ``ServeConfig`` and ``Engine``, on
one card: the engine takes a device where the reference takes a mesh, and
runs ``models.transformer.forward`` eagerly (there is no jit).  It serves
every family of the reference (dense, moe, vlm, audio, ssm and hybrid),
with the family's cache from ``init_decode_cache``, allocated once (KV
caches in the weights' dtype) and updated in place.  Every ``generate``
call starts from a fresh cache all the same: its recurrent states are
zeroed (``reset_decode_cache``) and its prefill rewrites every KV slot
(the prompt's keys and values, zeros after them), so a shorter second
prompt never attends over the first call's keys.  Decoding runs through
the K10 kernel under ``compute_policy(flash_decode=True)`` wherever the
model has attention on a linear cache.  Requests are admitted by
``serve.scheduler``.  ``make_prefill_step`` and ``make_decode_step`` (the
dry-run's jitted, sharded steps) wait for the launch tooling (ROADMAP.md
queue 1 item 14).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import (
    Cache, Transformer, forward, init_decode_cache, reset_decode_cache,
)
from repro_torch.ops.sort import Device, _device

__all__ = ["ServeConfig", "Engine"]


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    batch_size: int
    temperature: float = 0.0  # 0 = greedy


def _split(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """A child generator seeded from ``gen``'s next draw (the port's form of
    ``jax.random.split``)."""
    seed = int(torch.randint(0, 2**63 - 1, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


class Engine:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Transformer,
                 device: Device = None):
        self.cfg, self.scfg, self.params = cfg, scfg, params
        self.device = _device(device)
        where = {p.device.type for p in params.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"Engine on {self.device}: the parameters are on {where}")
        # allocated by the first generate(); each prefill rewrites it whole
        self.cache: Optional[Cache] = None

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """Greedy, or Gumbel-max (the reference's categorical sampler) with
        a child of ``gen`` split off for this one sample."""
        if self.scfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=_split(gen, logits.device), dtype=torch.float32,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
        scaled = logits.to(torch.float32) / self.scfg.temperature
        return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)

    @torch.no_grad()
    def generate(self, prompts, max_new: int, seed: int = 0) -> torch.Tensor:
        """prompts: (B, P) int tokens.  Returns (B, max_new) int32 tokens:
        the prefill's sample, then one per decode step at pos = P + i.  Runs
        under ``torch.no_grad()``: a model whose gradients a trainer turned
        on serves without recording a graph."""
        prompts = torch.as_tensor(prompts, device=self.device)
        b, plen = prompts.shape
        if b != self.scfg.batch_size:
            raise ValueError(f"{b} prompts for a batch of {self.scfg.batch_size}")
        if self.cache is None:
            self.cache = init_decode_cache(self.cfg, b, self.scfg.max_seq,
                                           dtype=self.params.dtype, device=self.device)
        else:
            reset_decode_cache(self.cache)
        logits, self.cache, _ = forward(self.params, self.cfg, prompts, cache=self.cache)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        toks = []
        tok = self._sample(logits[:, -1], gen)
        for i in range(max_new):
            toks.append(tok)
            pos = torch.full((b, 1), plen + i, dtype=torch.int32, device=self.device)
            logits, self.cache, _ = forward(self.params, self.cfg, tok[:, None], positions=pos,
                                            cache=self.cache)
            tok = self._sample(logits[:, 0], gen)
        return torch.stack(toks, dim=1)
