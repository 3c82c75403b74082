"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

Counterpart of ``repro.launch.dryrun``, where "lower and compile" becomes:

  1. start torch's ``fake`` process group of 256 (or 512) ranks and build
     the production ``DeviceMesh`` ((16, 16) or (2, 16, 16)) on it;
  2. under ``FakeTensorMode`` (shapes and dtypes, nothing allocated; fake
     ``cuda`` tensors on a card, fake ``cpu`` tensors elsewhere), build the
     model, place the parameters, optimizer state, batch and cache by the
     sharding rules (``launch.shardings``), and run the cell's train,
     prefill or decode step once, its collectives sent to no one;
  3. count the step's flops, bytes and collective bytes on rank 0 with the
     op-level counter (``launch.op_cost``) and write the roofline row
     (``launch.roofline``) with H100 constants.

There is no loop to multiply: a step traced at full depth with all its
microbatches would run 126 layers x 16 microbatches of DTensor ops.  So
each cell is traced at one and two layers (for the hybrid, one and two
groups of one and two Mamba2 layers), for training at two and three microbatches, and for RWKV-6
outside decode at 8 and 16 tokens (its recurrence is a loop over them),
and the counts are extrapolated multilinearly to the cell's values
(every count is affine in each; a test holds the extrapolation equal to a
full trace at reduced size).  ``t_lower_s`` is the time of those traces.
``memory`` holds each rank's argument bytes, exact from the local shard
shapes of the full-depth state (rank 0's, the largest: DTensor's shards
follow ``torch.chunk``), and a peak estimate: those plus the most bytes of
the step's temporaries alive at once (``op_cost.OpCost.peak``), traced and
extrapolated linearly in depth like the counts.  (torch's ``MemTracker``
counts DTensor's shape-propagation tensors, at their global size, when the
step runs under an outer fake mode, so it is not used.)

The fake group is global to its process: run this in a process of its own
(``lower_cell`` starts the group and destroys it), never inside a test
worker.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all --out results/dryrun  (40 cells)
  python -m repro_torch.launch.report results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import (
    SHAPES, Shape, cells, get_config, input_specs, shape_applicable,
)
from repro_torch.launch.mesh import (
    axis_sizes, dp_axes, fake_group, make_production_mesh, production_shape,
)
from repro_torch.launch.op_cost import OpCost, StepCost
from repro_torch.launch.roofline import axis_link_bw, model_flops, roofline_terms
from repro_torch.launch.shardings import (
    ShardingStrategy, batch_specs, cache_specs, local_shape, param_specs,
)

__all__ = ["default_microbatch", "lower_cell", "trace_cost", "main"]

_SKIP = "full-attention arch: long_500k needs sub-quadratic"
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def default_microbatch(cfg: ModelConfig, shape: Shape, mesh) -> int:
    """Accumulation so that per-dp-shard microbatch keeps live activations
    small (1 row/shard for the giant archs, 4 otherwise)."""
    sizes = axis_sizes(mesh)
    dp = 1
    for a in dp_axes(mesh):
        dp *= sizes[a]
    per_shard = 1 if cfg.d_model >= 8192 or cfg.num_layers >= 90 else 4
    mb = min(shape.global_batch, dp * per_shard)
    while shape.global_batch % mb:
        mb -= 1
    return max(1, mb)


def _device_type(device_type: Optional[str]) -> str:
    if device_type:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def _bytes(shape, mesh, spec, itemsize: int) -> int:
    n = 1
    for d in local_shape(shape, mesh, spec):
        n *= d
    return n * itemsize


def argument_bytes(cfg: ModelConfig, shape: Shape, mesh, strat: ShardingStrategy,
                   tcfg=None) -> int:
    """Rank 0's bytes of the step's arguments at full depth: parameters (and,
    training, moments, error feedback and the batch; serving, the inputs
    and the cache), from the meta-device shapes and the sharding rules."""
    from repro_torch.models.transformer import init_decode_cache, init_model

    model = init_model(torch.Generator(), cfg, device="meta")
    specs = param_specs(model, cfg, mesh, strat)
    from repro_torch.launch.shardings import leaf_path

    total = 0
    for name, p in model.named_parameters():
        spec = specs[leaf_path(name)]
        total += _bytes(p.shape, mesh, spec, p.element_size())
        if shape.kind == "train":
            for dt in (tcfg.adamw.m_dtype, tcfg.adamw.v_dtype):
                total += _bytes(p.shape, mesh, spec, _DTYPE_BYTES[dt])
            if tcfg.compress_grads:
                total += _bytes(p.shape, mesh, spec, 4)
    inputs = input_specs(cfg, shape)
    if shape.kind == "prefill":
        inputs["cache"] = init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                            device="meta")
    cache = inputs.pop("cache", None)
    for k, t in inputs.items():
        total += _bytes(t.shape, mesh, batch_specs(cfg, mesh, {k: t})[k], t.element_size())
    if cache is not None:
        cs = cache_specs(cfg, mesh, cache, strat)
        for group in ("layers", "attn"):
            for c, s in zip(cache.get(group, []), cs.get(group, [])):
                for k, t in c.items():
                    if isinstance(t, torch.Tensor):
                        total += _bytes(t.shape, mesh, s[k], t.element_size())
    return total


def _trace_once(kind: str, cfg: ModelConfig, shape: Shape, mesh, strat, tcfg, k_mb: int,
                dev: str) -> Tuple[StepCost, float]:
    """(the step's cost on rank 0, its temporaries' peak bytes) of one trace of
    ``cfg`` (a reduced depth) with ``k_mb`` microbatches (training)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.shardings import distribute, distribute_model
    from repro_torch.models.transformer import init_decode_cache, init_model, param_leaves
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.compression import init_error_feedback

    b, s = shape.global_batch, shape.seq_len
    with FakeTensorMode():
        gen = torch.Generator(device=dev)
        model = init_model(gen, cfg, device=dev)
        distribute_model(model, cfg, mesh, strat)
        counter = OpCost(mesh)
        if kind == "train":
            from repro_torch.train.trainer import make_train_step

            rows = k_mb * tcfg.microbatch
            step, _, _ = make_train_step(cfg, tcfg, mesh, strat, params_like=model)
            leaves = param_leaves(model)
            state = {"params": model, "opt": adamw_init(leaves, tcfg.adamw)}
            if tcfg.compress_grads:
                state["eff"] = init_error_feedback(leaves)
            if cfg.takes_embeds:
                inputs = torch.empty((rows, s, cfg.d_model), dtype=torch.bfloat16, device=dev)
            else:
                inputs = torch.empty((rows, s), dtype=torch.int32, device=dev)
            batch = {"inputs": inputs,
                     "labels": torch.empty((rows, s), dtype=torch.int32, device=dev)}
            with counter:
                step(state, batch)
        else:
            from repro_torch.serve.engine import make_decode_step, make_prefill_step

            cache = init_decode_cache(cfg, b, s, device=dev)
            cache = distribute(cache, cache_specs(cfg, mesh, cache, strat), mesh)
            if kind == "prefill":
                fn, _ = make_prefill_step(cfg, mesh, strat, model)
                shp = (b, s, cfg.d_model) if cfg.takes_embeds else (b, s)
                dt = torch.bfloat16 if cfg.takes_embeds else torch.int32
                with counter:
                    fn(model, torch.empty(shp, dtype=dt, device=dev), cache)
            else:
                for group in cache.values():  # one token against a full cache
                    for c in group:
                        if "pos" in c:
                            c["pos"] = s - 1
                fn, _ = make_decode_step(cfg, mesh, strat, model)
                shp = (b, 1, cfg.d_model) if cfg.takes_embeds else (b, 1)
                dt = torch.bfloat16 if cfg.takes_embeds else torch.int32
                pos = torch.full((b, 1), s - 1, dtype=torch.int32, device=dev)
                with counter:
                    fn(model, torch.empty(shp, dtype=dt, device=dev), pos, cache)
    return counter.cost, counter.peak


def _plan(kind: str, cfg: ModelConfig, shape: Shape, steps: Optional[int]):
    """The trip variables of a cell's step: (name, the two traced values,
    the cell's value): the layers (for the hybrid, its groups and the
    Mamba2 layers a group); microbatches for training; and tokens for
    RWKV-6 (whose recurrence is a loop over them, every count affine in
    their number) outside decode."""
    if cfg.family == "hybrid":  # groups of Mamba2 layers, each closed by the shared attention
        every = cfg.ssm.attn_every
        plan = [("groups", (1, 2), cfg.num_layers // every), ("per_group", (1, 2), every)]
    else:
        plan = [("layers", (1, 2), cfg.num_layers)]
    if kind == "train":
        plan.append(("microbatches", (2, 3), steps))
    if cfg.family == "ssm" and kind != "decode":
        plan.append(("tokens", (8, 16), shape.seq_len))
    return plan


def trace_cost(kind: str, cfg: ModelConfig, shape: Shape, mesh, strat, tcfg, dev: str,
               *, steps: Optional[int] = None) -> Tuple[StepCost, StepCost, float, Dict]:
    """The step's cost at ``cfg``'s depth, ``steps`` microbatches and the
    shape's tokens, from traces at two values of each trip variable
    (``_plan``), extrapolated multilinearly (exact for counts affine in
    each).  Returns (cost, the smallest trace's cost, peak estimate,
    trips)."""
    import itertools

    plan = _plan(kind, cfg, shape, steps)
    terms, peak, first = [], 0.0, None
    for corner in itertools.product((0, 1), repeat=len(plan)):
        vals = {name: pts[c] for (name, pts, _), c in zip(plan, corner)}
        weight = 1.0
        for (name, (a, b), x), c in zip(plan, corner):
            weight *= (x - a) / (b - a) if c else (b - x) / (b - a)
        if cfg.family == "hybrid":
            c_cfg = dataclasses.replace(
                cfg, num_layers=vals["groups"] * vals["per_group"],
                ssm=dataclasses.replace(cfg.ssm, attn_every=vals["per_group"]))
        else:
            c_cfg = dataclasses.replace(cfg, num_layers=vals["layers"])
        c_shape = dataclasses.replace(shape, seq_len=vals.get("tokens", shape.seq_len))
        cost, pk = _trace_once(kind, c_cfg, c_shape, mesh, strat, tcfg,
                               vals.get("microbatches", 1), dev)
        first = first or cost
        terms.append((weight, cost))
        peak += weight * pk
    cost = StepCost.combine(terms)
    trips = {name: x for name, _, x in plan}
    cost.trips = dict(trips)
    cost.n_while = len(plan)
    return cost, first, peak, trips


def _op_table(cost: StepCost) -> str:
    """The counted ops, the dry run's stand-in for HLO text."""
    lines = [f"# flops {cost.flops:.6e} bytes {cost.bytes:.6e} bytes_min {cost.bytes_min:.6e}",
             f"# collectives {json.dumps(cost.coll)} by axis {json.dumps(cost.coll_by_axis)}",
             f"# trips {json.dumps(cost.trips)}",
             f"{'op':40s} {'count':>14s} {'bytes':>16s}"]
    for name in sorted(cost.ops, key=lambda n: -cost.bytes_by_op.get(n, 0.0)):
        lines.append(f"{name:40s} {cost.ops[name]:14.1f} {cost.bytes_by_op.get(name, 0.0):16.6e}")
    return "\n".join(lines) + "\n"


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               strat: ShardingStrategy = ShardingStrategy(), tcfg=None,
               verbose: bool = True, hlo_out: Optional[str] = None, flash_block: int = 0,
               explicit_ep: bool = False, device_type: Optional[str] = None) -> Dict[str, Any]:
    """The cell's row: traced on the production mesh of a fake group that
    this call starts and destroys."""
    from repro_torch.models.policy import compute_policy
    from repro_torch.train.trainer import TrainConfig

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(cfg, shape):
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": _SKIP}
    dims, names = production_shape(multi_pod)
    chips = 1
    for n in dims:
        chips *= n
    mesh_name = "x".join(str(n) for n in dims)
    dev = _device_type(device_type)
    with fake_group(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=dev)
        steps = None
        if shape.kind == "train":
            if tcfg is None:
                tcfg = TrainConfig(microbatch=default_microbatch(cfg, shape, mesh))
            elif not tcfg.microbatch:
                tcfg = dataclasses.replace(tcfg, microbatch=default_microbatch(cfg, shape, mesh))
            steps = shape.global_batch // tcfg.microbatch
        t0 = time.perf_counter()
        with compute_policy(flash_block=flash_block, explicit_ep=explicit_ep):
            cost, raw, peak, trips = trace_cost(shape.kind, cfg, shape, mesh, strat, tcfg,
                                                dev, steps=steps)
        t_lower = time.perf_counter() - t0
        args = argument_bytes(cfg, shape, mesh, strat, tcfg)
        # the step's arguments are read once and its outputs written once
        cost.bytes_min += args
        axis_bw = {}
        stride = chips
        for n, a in zip(dims, names):
            stride //= n
            axis_bw[a] = axis_link_bw(n, stride)
    if hlo_out:
        with open(hlo_out, "w") as f:
            f.write(_op_table(cost))
    mem = {"argument_size_in_bytes": int(args), "temp_size_in_bytes": int(peak),
           "peak_memory_in_bytes": int(args + peak)}
    rep = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips, cost=cost,
        model_fl=model_flops(cfg, shape), axis_bw=axis_bw, peak_mem=mem["peak_memory_in_bytes"],
        note=f"traced on fake {dev} tensors; trips {json.dumps(trips)}", raw=raw)
    row = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
           "status": "ok", "t_lower_s": round(t_lower, 1), "t_compile_s": 0.0,
           "memory": mem, "roofline": json.loads(rep.to_json())}
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] traced in {t_lower:.1f}s; mem={mem}",
              flush=True)
        print(f"  flops/dev={rep.flops_per_dev:.3e} bytes/dev={rep.bytes_per_dev:.3e} "
              f"coll/dev={rep.coll_bytes_per_dev:.3e} bottleneck={rep.bottleneck}", flush=True)
        print(f"  t_comp={rep.t_compute*1e3:.2f}ms t_mem={rep.t_memory*1e3:.2f}ms "
              f"(min {rep.t_memory_min*1e3:.2f}ms) t_coll={rep.t_collective*1e3:.2f}ms "
              f"useful={rep.useful_ratio:.2f} bott_min={rep.bottleneck_min}", flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="write one JSON per cell here")
    ap.add_argument("--seq-shard-cache", action="store_true", default=None)
    ap.add_argument("--save-hlo", default=None,
                    help="write each cell's counted op table here (no HLO exists)")
    ap.add_argument("--flash", type=int, default=0,
                    help="flash-attention KV block size (0 = eager baseline)")
    ap.add_argument("--explicit-ep", action="store_true",
                    help="expert parallelism for MoE archs")
    ap.add_argument("--tag", default=None,
                    help="suffix for --out/--save-hlo filenames")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="override gradient-accumulation microbatch size")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device-type", default=None,
                    help="fake tensors' device: cuda where a card is, else cpu")
    args = ap.parse_args(argv)

    strat = ShardingStrategy(seq_shard_cache=args.seq_shard_cache)
    todo = (cells(include_inapplicable=True) if args.all else [(args.arch, args.shape)])
    failures = 0
    for arch, shape in todo:
        pod = "2pod" if args.multi_pod else "1pod"
        if args.tag:
            pod = f"{pod}__{args.tag}"
        try:
            hlo_out = None
            if args.save_hlo:
                os.makedirs(args.save_hlo, exist_ok=True)
                hlo_out = os.path.join(args.save_hlo, f"{arch}__{shape}__{pod}.ops.txt")
            tcfg = None
            if args.microbatch or args.compress_grads:
                from repro_torch.train.trainer import TrainConfig

                tcfg = TrainConfig(microbatch=args.microbatch,
                                   compress_grads=args.compress_grads)
            row = lower_cell(arch, shape, multi_pod=args.multi_pod, strat=strat,
                             hlo_out=hlo_out, tcfg=tcfg, flash_block=args.flash,
                             explicit_ep=args.explicit_ep, device_type=args.device_type)
        except Exception as e:  # a failure here is a bug in the sharding
            traceback.print_exc()
            row = {"arch": arch, "shape": shape, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "mesh": "2x16x16" if args.multi_pod else "16x16"}
            failures += 1
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = os.path.join(args.out, f"{arch}__{shape}__{pod}.json")
            with open(fn, "w") as f:
                json.dump(row, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
