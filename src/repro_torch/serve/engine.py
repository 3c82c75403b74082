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
``serve.scheduler``.

``make_prefill_step`` and ``make_decode_step`` are the reference's step
factories (the dry run's ``prefill_32k``, ``decode_32k`` and ``long_500k``
cells): ``prefill(params, inputs, cache) -> (last logits, cache)`` and
``decode(params, tok, pos, cache) -> (logits, cache)``, over a
``DeviceMesh`` with the parameters placed by ``launch.shardings``'
``param_specs`` and the cache by ``cache_specs`` (``shardings.distribute``),
or on one device without a mesh.  Where the reference donates the cache,
the port updates it in place.  ``Engine(mesh=)`` runs its generation through
those steps.
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

__all__ = ["ServeConfig", "Engine", "make_prefill_step", "make_decode_step"]


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int
    batch_size: int
    temperature: float = 0.0  # 0 = greedy


def _specs(cfg: ModelConfig, mesh, strat, params_like):
    from repro_torch.launch.shardings import ShardingStrategy, named, param_specs
    from repro_torch.models.transformer import init_model

    if mesh is None:
        return None
    if params_like is None:
        params_like = init_model(torch.Generator(), cfg, device="meta")
    return named(mesh, param_specs(params_like, cfg, mesh, strat or ShardingStrategy()))


def _on_mesh(mesh, f):
    """``f`` run without autograd under ``mesh`` (the ambient mesh of
    ``shard_hint`` and the MoE; plain tensors taken as replicated)."""
    @torch.no_grad()
    def run(*args):
        if mesh is None:
            return f(*args)
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.models.layers import ambient_mesh

        with ambient_mesh(mesh), implicit_replication():
            return f(*args)

    return run


def _place_batch(cfg: ModelConfig, mesh, x):
    """Tokens or embeddings placed by ``batch_specs`` (a plain tensor is the
    whole batch, held by every rank alike)."""
    from torch.distributed.tensor import DTensor

    if mesh is None or isinstance(x, DTensor):
        return x
    from repro_torch.launch.shardings import batch_specs, distribute

    return distribute(x, batch_specs(cfg, mesh, x), mesh)


def make_prefill_step(cfg: ModelConfig, mesh=None, strat=None, params_like=None):
    """``prefill(params, inputs, cache) -> (last logits (B, V), cache)``, and
    the parameters' placements (None without a mesh).  The cache (placed by
    ``cache_specs`` over a mesh) is updated in place: the port's form of the
    reference's donated buffer (its ``donate_cache`` flag has no
    counterpart)."""
    psh = _specs(cfg, mesh, strat, params_like)

    def prefill(params, inputs, cache):
        logits, cache, _ = forward(params, cfg, _place_batch(cfg, mesh, inputs), cache=cache)
        return logits[:, -1], cache

    return _on_mesh(mesh, prefill), psh


def make_decode_step(cfg: ModelConfig, mesh=None, strat=None, params_like=None):
    """``decode(params, tok, pos, cache) -> (logits (B, V), cache)``, and the
    parameters' placements (None without a mesh).  Updates the cache in
    place (the reference donates it)."""
    psh = _specs(cfg, mesh, strat, params_like)

    def decode(params, tok, pos, cache):
        logits, cache, _ = forward(params, cfg, _place_batch(cfg, mesh, tok),
                                   positions=_place_batch(cfg, mesh, pos), cache=cache)
        return logits[:, 0], cache

    return _on_mesh(mesh, decode), psh


def _whole(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _split(gen: torch.Generator, device: torch.device) -> torch.Generator:
    """A child generator seeded from ``gen``'s next draw (the port's form of
    ``jax.random.split``)."""
    seed = int(torch.randint(0, 2**63 - 1, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


class Engine:
    """Generation on ``device`` (the card by default), or over ``mesh`` (a
    ``DeviceMesh``): the parameters are placed by the sharding rules (in
    place), the cache by ``cache_specs``, and every step is the sharded
    ``make_prefill_step`` / ``make_decode_step``."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params: Transformer,
                 device: Device = None, mesh=None, strat=None):
        self.cfg, self.scfg, self.params, self.mesh = cfg, scfg, params, mesh
        self.strat = strat
        self.device = _device(device) if mesh is None else torch.device(mesh.device_type)
        where = {p.device.type for p in params.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"Engine on {self.device}: the parameters are on {where}")
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            from repro_torch.launch.shardings import ShardingStrategy, distribute_model

            if not any(isinstance(p, DTensor) for p in params.parameters()):
                distribute_model(params, cfg, mesh, strat or ShardingStrategy())
        self.prefill_fn, _ = make_prefill_step(cfg, mesh, strat, params)
        self.decode_fn, _ = make_decode_step(cfg, mesh, strat, params)
        # allocated by the first generate(); each prefill rewrites it whole
        self.cache: Optional[Cache] = None

    def _new_cache(self, b: int) -> Cache:
        cache = init_decode_cache(self.cfg, b, self.scfg.max_seq, dtype=self.params.dtype,
                                  device=self.device)
        if self.mesh is None:
            return cache
        from repro_torch.launch.shardings import ShardingStrategy, cache_specs, distribute

        specs = cache_specs(self.cfg, self.mesh, cache, self.strat or ShardingStrategy())
        return distribute(cache, specs, self.mesh)

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
            self.cache = self._new_cache(b)
        else:
            reset_decode_cache(self.cache)
        logits, self.cache = self.prefill_fn(self.params, prompts, self.cache)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        toks = []
        tok = self._sample(_whole(logits), gen)
        for i in range(max_new):
            toks.append(tok)
            pos = torch.full((b, 1), plen + i, dtype=torch.int32, device=self.device)
            logits, self.cache = self.decode_fn(self.params, tok[:, None], pos, self.cache)
            tok = self._sample(_whole(logits), gen)
        return torch.stack(toks, dim=1)
