"""Training loop: the step function factory and the fault-tolerant driver.

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
optimizer's trees are keyed by ``models.transformer.param_leaves``.  Over a
``DeviceMesh`` the step is sharded as the reference's is: parameters,
moments and error feedback are DTensors placed by
``launch.shardings.param_specs`` (ZeRO by construction), each microbatch
is placed by ``batch_specs``, and the model runs under the mesh, where
DTensor inserts the collectives that GSPMD inserts in the reference.

``Trainer`` is the driver (on one device, or over a mesh):
checkpoint/restart through the port's ``checkpoint.CheckpointManager``
(atomic, async), straggler detection by the p95 of recent step times, one
host read of the loss per step (the reference's ``block_until_ready``).
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
from repro_torch.optim.adamw import (
    AdamWConfig, _like, _parts, adamw_init, adamw_update, scalar_like,
)
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


def _accumulate_grads(cfg: ModelConfig, tcfg: TrainConfig, model: Transformer, batch,
                      place: Callable = lambda b: b):
    """Microbatched loss and gradients; returns (loss, metrics, grads) with
    ``grads`` keyed like ``param_leaves(model)``.  ``place`` lays out each
    microbatch (the sharded step's batch placement)."""
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
        loss, metrics, grads = loss_and_grads(place(batch))
        return loss, metrics, regroup(grads)

    # zeros_like: a DTensor parameter's buffer takes its placements, and the
    # add below reduces each microbatch's partial gradient into it
    acc = [torch.zeros_like(t, dtype=torch.float32) for t in flat]
    loss_sum = scalar_like(flat[0], torch.float32)
    for i in range(steps):
        loss, metrics, grads = loss_and_grads(
            place({k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}))
        for a, g in zip(acc, grads):
            a.add_(g.to(torch.float32))
        del grads
        loss_sum = loss_sum + loss
    for a in acc:
        a.div_(steps)
    return loss_sum / steps, metrics, regroup(acc)


def _to_placements(grads: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """Each DTensor gradient laid out as its parameter (the data-parallel
    reduction: a reduce-scatter or all-reduce of the partial sums)."""
    from torch.distributed.tensor import DTensor

    def lay(g, t):
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(t.placements):
            return g.redistribute(t.device_mesh, t.placements)
        return g

    return {k: _like(p, [lay(g, t) for g, t in zip(_parts(grads[k]), _parts(p))])
            for k, p in params.items()}


def _opt_specs(opt: Dict[str, Any], pspecs: Dict[str, Any]) -> Dict[str, Any]:
    """Moments are congruent to params except int8 {q, scale} leaves, whose
    scale is replicated; the step is replicated."""
    from repro_torch.launch.shardings import Spec

    def per_moment(mtree):
        return {k: ({"q": pspecs[k], "scale": Spec()} if isinstance(m, dict) else pspecs[k])
                for k, m in mtree.items()}

    return {"m": per_moment(opt["m"]), "v": per_moment(opt["v"]), "step": Spec()}


def _full_batch(v, dev):
    """A batch tensor whole on this rank (every rank is given the global
    batch, as the reference's step takes a global array)."""
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):
        return v.full_tensor()
    return torch.as_tensor(v, device=dev)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None, strat=None,
                    params_like: Optional[Transformer] = None, batch_like: Any = None,
                    device: Device = None):
    """Without a mesh, returns ``step(state, batch) -> (state, metrics)``;
    the state is updated in place and returned.  ``batch`` ({"inputs",
    "labels"}, numpy or tensors) is moved to ``device`` (the card by
    default; raises without one).

    With a ``DeviceMesh`` (of any size; its axes among "pod", "data" and
    "model") returns ``(step, state_shardings, batch_sharding_fn)`` as the
    reference does: the state's parameters and moments are DTensors placed
    by ``launch.shardings.param_specs`` (an int8 moment's scale and the
    step replicated; ``Trainer`` and ``shardings.distribute_model`` make
    them so), ``state_shardings`` is the tree of those placements (for
    ``params_like``, a model of the config's shapes, e.g. on the meta
    device; built from the config when None), and ``batch_sharding_fn(b)``
    gives a batch's.  Every rank passes the whole global batch: each
    microbatch (rows ``i*mb`` to ``(i+1)*mb``, the reference's) is placed
    by ``batch_specs`` before its forward, the gradients are reduced to
    their parameters' placements, and AdamW runs on the shards.  The model
    runs under the mesh (``layers.ambient_mesh``, so ``shard_hint`` and the
    MoE's expert-parallel column see it) with plain tensors taken as
    replicated.  ``batch_like`` is accepted for the reference's signature
    (a DTensor step places each batch as it comes)."""
    dev = _device(device) if mesh is None else torch.device(mesh.device_type)
    if mesh is not None:
        from repro_torch.launch.mesh import axis_sizes

        bad = set(axis_sizes(mesh)) - {"pod", "data", "model"}
        if bad or "model" not in axis_sizes(mesh):
            raise ValueError(f"a train step's mesh has axes among pod, data and model, "
                             f"model included; got {tuple(mesh.mesh_dim_names)}")

    def update(state, loss, metrics, grads):
        model = state["params"]
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

    if mesh is None:
        def step(state: Dict[str, Any], batch) -> tuple:
            model = state["params"]
            model.requires_grad_(True)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            return update(state, *_accumulate_grads(cfg, tcfg, model, batch))

        return step

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.shardings import (
        ShardingStrategy, batch_specs, distribute, named, param_specs,
    )
    from repro_torch.models.layers import ambient_mesh

    strat = strat or ShardingStrategy()

    def place(b):
        return distribute(b, batch_specs(cfg, mesh, b), mesh)

    def sharded_step(state: Dict[str, Any], batch) -> tuple:
        model = state["params"]
        model.requires_grad_(True)
        batch = {k: _full_batch(v, dev) for k, v in batch.items()}
        with ambient_mesh(mesh), implicit_replication():
            loss, metrics, grads = _accumulate_grads(cfg, tcfg, model, batch, place=place)
            grads = _to_placements(grads, param_leaves(model))
            return update(state, loss, metrics, grads)

    if params_like is None:
        params_like = init_model(torch.Generator(), cfg, device="meta")
    pspecs = param_specs(params_like, cfg, mesh, strat)
    opt_like = adamw_init(param_leaves(params_like), tcfg.adamw)
    state_specs = {"params": pspecs, "opt": _opt_specs(opt_like, pspecs)}
    if tcfg.compress_grads:
        state_specs["eff"] = pspecs
    state_sh = named(mesh, state_specs)

    def batch_sharding_fn(bl):
        return named(mesh, batch_specs(cfg, mesh, bl))

    return sharded_step, state_sh, batch_sharding_fn


def _host(v) -> float:
    """A 0-d metric as a Python float (a DTensor's full value)."""
    from torch.distributed.tensor import DTensor

    return float(v.full_tensor() if isinstance(v, DTensor) else v)


def _local(t):
    """A DTensor's shard on this rank (its storage: a copy into it writes
    the DTensor); any other leaf as it is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


class Trainer:
    """Fault-tolerant driver around the step, on ``device`` (the card by
    default), or over ``mesh`` (a ``DeviceMesh``: the sharded step, its
    parameters and moments DTensors; the device is the mesh's).  Over a
    mesh a checkpoint holds each rank's own shards (the port's
    ``CheckpointManager``, one file per rank and leaf), and restores onto a
    mesh of the same shape; the reference re-lays a checkpoint out onto any
    mesh."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                 ckpt_dir: Optional[str] = None, seed: int = 0, device: Device = None,
                 strat=None):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        if mesh is None:
            self.device = _device(device)
            self.step_fn = make_train_step(cfg, tcfg, device=self.device)
        else:
            self.device = torch.device(mesh.device_type)
            self.step_fn, self.state_sh, self._batch_sh = make_train_step(
                cfg, tcfg, mesh, strat)
        self.strat = strat
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.seed = seed
        self.step_times: list = []  # straggler ledger
        self.state: Any = None
        self.step_num = 0

    def init_state(self) -> Dict[str, Any]:
        """Parameters from a generator seeded with ``seed`` on the device,
        gradients on (placed by the sharding rules over a mesh); zero
        moments (and error feedback)."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        model = init_model(gen, self.cfg, device=self.device)
        if self.mesh is not None:
            from repro_torch.launch.shardings import ShardingStrategy, distribute_model

            distribute_model(model, self.cfg, self.mesh, self.strat or ShardingStrategy())
        model.requires_grad_(True)
        leaves = param_leaves(model)
        self.state = {"params": model, "opt": adamw_init(leaves, self.tcfg.adamw)}
        if self.tcfg.compress_grads:
            self.state["eff"] = init_error_feedback(leaves)
        return self.state

    def _tree(self) -> Dict[str, Any]:
        """The state as a tree of tensors, this rank's shards over a mesh
        (what a checkpoint holds)."""
        tree = {**self.state, "params": param_leaves(self.state["params"])}
        return pytree.tree_map(_local, tree)

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
        with torch.no_grad():
            like = self._tree()
            saved = self.ckpt.restore(latest, like)
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
            _host(metrics["loss"])  # the step's one host read: it waits for the step
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            if deadline and dt > deadline:
                log(f"[straggler] step {self.step_num} took {dt:.2f}s "
                    f"(deadline {deadline:.2f}s) — flagged")
            deadline = self.straggler_deadline()
            self.step_num += 1
            if self.step_num % log_every == 0:
                last_metrics = {k: _host(v) for k, v in metrics.items()}
                log(f"step {self.step_num}: " + " ".join(
                    f"{k}={v:.4g}" for k, v in last_metrics.items()))
            if self.ckpt and self.step_num % ckpt_every == 0:
                self.ckpt.save(self.step_num, self._tree(), blocking=False)
        if self.ckpt:
            self.ckpt.save(self.step_num, self._tree(), blocking=True)
        if not last_metrics:
            last_metrics = {k: _host(v) for k, v in metrics.items()}
        return last_metrics
