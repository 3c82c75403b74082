"""Training loop on one card: the step function factory and the
fault-tolerant driver.

Counterpart of ``repro.train.trainer``.  ``make_train_step`` builds the
step, which runs eagerly on the parameters where they lie:

  * microbatched gradient accumulation: a Python loop over the
    microbatches (the reference's ``lax.scan``) summing each one's
    gradients into float32 buffers, then dividing by their count; a single
    shot (``microbatch`` 0 or the whole batch) keeps the parameters' dtype,
    as ``jax.value_and_grad`` does;
  * per-layer remat inside the model (``cfg.remat``, by
    ``torch.utils.checkpoint``);
  * optional int8 error-feedback gradient compression right before the
    optimizer, where the reference's data-parallel reduction would follow;
  * AdamW with memory-tiered moments under the linear-warmup cosine
    schedule, updating the parameters in place.

The state is ``{"params": the Transformer, "opt": the AdamW state,
"eff": the error feedback}`` (``eff`` with compression only); the
optimizer's trees are keyed by ``models.transformer.param_leaves``.  The
reference's sharded steps (its ``ShardingStrategy`` and state shardings)
belong to the launch tooling (ROADMAP.md queue 1 item 14): a mesh of more
than one device raises ``NotImplementedError``.

``Trainer`` is the driver: checkpoint/restart through the port's
``checkpoint.CheckpointManager`` (atomic, async), straggler detection by
the p95 of recent step times, one host read of the loss per step (the
reference's ``block_until_ready``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import Transformer, init_model, param_leaves, train_loss
from repro_torch.optim.adamw import AdamWConfig, _like, _parts, adamw_init, adamw_update
from repro_torch.optim.compression import (
    compress_grads, decompress_grads, init_error_feedback,
)
from repro_torch.optim.schedule import linear_warmup_cosine
from repro_torch.ops.sort import Device, _device

__all__ = ["TrainConfig", "make_train_step", "Trainer"]


@dataclass(frozen=True)
class TrainConfig:
    microbatch: int = 0            # 0 = no accumulation (single shot)
    warmup_steps: int = 100
    total_steps: int = 1000
    compress_grads: bool = False   # int8 error-feedback gradients
    adamw: AdamWConfig = field(default_factory=AdamWConfig)
    lb_coef: float = 0.01          # MoE load-balance coefficient


def _accumulate_grads(cfg: ModelConfig, tcfg: TrainConfig, model: Transformer, batch):
    """Microbatched loss and gradients; returns (loss, metrics, grads) with
    ``grads`` keyed like ``param_leaves(model)``."""
    params = param_leaves(model)
    flat = [t for leaf in params.values() for t in _parts(leaf)]

    def regroup(gs):
        out, i = {}, 0
        for name, leaf in params.items():
            n = len(_parts(leaf))
            out[name] = _like(leaf, gs[i:i + n])
            i += n
        return out

    def loss_and_grads(b):
        loss, metrics = train_loss(model, cfg, b, lb_coef=tcfg.lb_coef)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    gb = batch["labels"].shape[0]
    mb = tcfg.microbatch or gb
    if gb % mb:
        raise ValueError(f"global batch {gb} % microbatch {mb}")
    steps = gb // mb
    if steps == 1:
        loss, metrics, grads = loss_and_grads(batch)
        return loss, metrics, regroup(grads)

    acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in flat]
    loss_sum = torch.zeros((), dtype=torch.float32, device=flat[0].device)
    for i in range(steps):
        loss, metrics, grads = loss_and_grads(
            {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        for a, g in zip(acc, grads):
            a.add_(g.to(torch.float32))
        del grads
        loss_sum = loss_sum + loss
    for a in acc:
        a.div_(steps)
    return loss_sum / steps, metrics, regroup(acc)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    device: Device = None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``; the state is
    updated in place and returned.  ``batch`` ({"inputs", "labels"}, numpy
    or tensors) is moved to ``device`` (the card by default; raises without
    one).  ``mesh``: None or a one-device ``DeviceMesh``."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"a train step over {mesh.size()} devices: the sharded steps wait for "
            "the launch tooling (ROADMAP.md queue 1 item 14)")
    dev = _device(device)

    def step(state: Dict[str, Any], batch) -> tuple:
        model = state["params"]
        model.requires_grad_(True)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        loss, metrics, grads = _accumulate_grads(cfg, tcfg, model, batch)
        if tcfg.compress_grads:
            comp, new_eff = compress_grads(grads, state["eff"])
            grads = decompress_grads(comp, grads)
        lr_scale = linear_warmup_cosine(state["opt"]["step"], tcfg.warmup_steps,
                                        tcfg.total_steps)
        _, new_opt, opt_metrics = adamw_update(param_leaves(model), grads, state["opt"],
                                               tcfg.adamw, lr_scale)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        new_state = {"params": model, "opt": new_opt}
        if tcfg.compress_grads:
            new_state["eff"] = new_eff
        return new_state, metrics

    return step


class Trainer:
    """Fault-tolerant driver around the step, on ``device`` (the card by
    default)."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 ckpt_dir: Optional[str] = None, seed: int = 0, device: Device = None):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = _device(device)
        self.step_fn = make_train_step(cfg, tcfg, mesh, device=self.device)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        self.step_times: list = []  # straggler ledger
        self.state: Any = None
        self.step_num = 0

    def init_state(self) -> Dict[str, Any]:
        """Parameters from a generator seeded with ``seed`` on the device,
        gradients on; zero moments (and error feedback)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = init_model(gen, self.cfg, device=self.device).requires_grad_(True)
        leaves = param_leaves(model)
        self.state = {"params": model, "opt": adamw_init(leaves, self.tcfg.adamw)}
        if self.tcfg.compress_grads:
            self.state["eff"] = init_error_feedback(leaves)
        return self.state

    def _tree(self) -> Dict[str, Any]:
        """The state as a tree of tensors (what a checkpoint holds)."""
        return {**self.state, "params": param_leaves(self.state["params"])}

    def maybe_restore(self) -> bool:
        """Resume from the newest complete checkpoint, in place.  Returns True
        if restored."""
        if self.ckpt is None:
            return False
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.state is None:
            self.init_state()
        like = self._tree()
        saved = self.ckpt.restore(latest, like)
        with torch.no_grad():
            for dst, src in zip(pytree.tree_leaves(like), pytree.tree_leaves(saved)):
                dst.copy_(src)
        self.step_num = latest
        return True

    def straggler_deadline(self) -> Optional[float]:
        """p95 * 3 of recent step times — steps exceeding it are flagged."""
        if len(self.step_times) < 5:
            return None
        return float(np.percentile(self.step_times[-50:], 95)) * 3.0

    def run(self, data_iter, num_steps: int, ckpt_every: int = 100,
            log_every: int = 10, log=print) -> Dict[str, float]:
        last_metrics: Dict[str, float] = {}
        deadline = None
        metrics: Dict[str, torch.Tensor] = {}
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in next(data_iter).items()}
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(self.state, batch)
            float(metrics["loss"])  # the step's one host read: it waits for the step
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if deadline and dt > deadline:
                log(f"[straggler] step {self.step_num} took {dt:.2f}s "
                    f"(deadline {deadline:.2f}s) — flagged")
            deadline = self.straggler_deadline()
            self.step_num += 1
            if self.step_num % log_every == 0:
                last_metrics = {k: float(v) for k, v in metrics.items()}
                log(f"step {self.step_num}: " + " ".join(
                    f"{k}={v:.4g}" for k, v in last_metrics.items()))
            if self.ckpt and self.step_num % ckpt_every == 0:
                self.ckpt.save(self.step_num, self._tree(), blocking=False)
        if self.ckpt:
            self.ckpt.save(self.step_num, self._tree(), blocking=True)
        if not last_metrics:
            last_metrics = {k: float(v) for k, v in metrics.items()}
        return last_metrics
