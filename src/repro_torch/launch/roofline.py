"""Roofline terms of a dry-run cell, with NVIDIA H100 constants.

Counterpart of ``repro.launch.roofline``.  Three terms per (arch x shape x
mesh) cell, from the op-level counter (``launch.op_cost``), per rank:

  compute    = flops_per_dev      / HW["peak_flops"]  (dense bf16)
  memory     = bytes_per_dev      / HW["hbm_bw"]
  collective = sum over mesh axes of the axis's wire bytes / its link rate

``HW`` holds the rated figures of the NVIDIA H100 80GB HBM3 (SXM) at its
700 W limit, from the data sheet: 989e12 dense bf16 FLOP/s on the tensor
cores (494.7e12 tf32; 67e12 for 32-bit float work outside them, which the
kernels' bounds also take for 32-bit integer work), HBM3 at 3.35e12 B/s
and 80 GB, NVLink 4 at 450e9 B/s each way per GPU within a node of 8, 132
SMs and 232,448 B of shared memory a block may use.  Traffic between
nodes is a deployment assumption, not a property of the card: 50e9 B/s
per GPU (one 400 Gb/s NIC each).  A mesh axis whose group spans nodes (on
the production meshes every axis does: the 16-wide ``model`` axis covers
two nodes) is charged at that rate, one within a node at NVLink's.
``chip_smoke.py`` takes its kernels' bounds from this one table.

There is no HLO to parse, so the reference's ``collective_bytes`` has no
counterpart: the counter counts the collectives as they run.
``KernelLaunchSpec``, ``spec_candidates``, ``launch_spec`` and
``classify_tile_rows`` describe the port's real launches: the tile and the
CTA (threads, shared bytes) that its kernels' own schedules give (K6's
``dispatch_rank.schedule``, K1's warp per 512 positions, K5's 256 threads
a CTA, K7's ``classify.schedule``), and count the reference's ``launch.spec``
obs counter.  They choose nothing: no tile a kernel launches depends on
them, and only the tests read them (the reference's kernels call
``launch_spec`` for their tiles; the port's keep their own schedules).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional

__all__ = ["HW", "roofline_terms", "RooflineReport", "model_flops", "classify_tile_rows",
           "KernelLaunchSpec", "launch_spec", "spec_candidates", "axis_link_bw"]

# NVIDIA H100 80GB HBM3 (SXM), 700 W: the data sheet's rated figures
HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700,
    "peak_flops": 989e12,       # dense bf16, tensor cores
    "tf32_flops": 494.7e12,     # dense tf32, tensor cores
    "fp32_flops": 67e12,        # 32-bit float outside the tensor cores
    "hbm_bw": 3.35e12,          # B/s
    "hbm_bytes": 80e9,          # capacity
    "nvlink_bw": 450e9,         # B/s each way per GPU (NVLink 4)
    "node_gpus": 8,             # GPUs a node joins by NVLink
    "inter_node_bw": 50e9,      # B/s per GPU between nodes: an assumption (400 Gb/s)
    "sms": 132,
    "smem_per_block": 232_448,  # shared memory a CTA may use
}

_WARP = 32


@dataclass(frozen=True)
class KernelLaunchSpec:
    """One kernel launch's shape: ``rows`` x ``lanes`` elements a CTA (or
    a grid step of a persistent CTA) takes, the CTA's ``threads`` and
    ``smem_bytes`` of shared memory, against ``smem_budget`` (what one CTA
    may use).  ``rows == 0``: no candidate tile divides the n asked for."""

    kind: str
    rows: int
    lanes: int = _WARP
    threads: int = 0
    smem_bytes: int = 0
    smem_budget: int = HW["smem_per_block"]

    @property
    def tile(self) -> int:
        """Elements per CTA step."""
        return self.rows * self.lanes


def _shape(kind: str, key_bytes: int, k: Optional[int], tile: int):
    """(lanes, threads, shared bytes) of kernel ``kind`` at ``tile``
    elements a CTA, or None where the kernel takes no such tile."""
    if kind == "rank":  # K6: a warp per 512 ids, as many as shared memory holds
        from repro_torch.kernels import dispatch_rank as dr

        nb = k or 1
        warps, t = dr.schedule(nb, tile)
        if t != tile:
            return None
        return _WARP, warps * _WARP, dr._smem_bytes(nb, warps)
    if kind == "level_fused":  # K1: a warp per 512 positions (256 for 8-byte keys)
        from repro_torch.kernels import level_fused as lf

        span = 256 if key_bytes == 8 else 512
        top = lf.MAX_TILE64 if key_bytes == 8 else lf.MAX_TILE
        if tile > top or tile % span:
            return None
        return _WARP, tile // span * _WARP, 0
    if kind == "merge":  # K5: 256 threads, 8 outputs each a step
        from repro_torch.kernels import merge_path as mp

        if tile > mp.max_tile(key_bytes) or tile < 256:
            return None
        return _WARP, 256, 0
    if kind == "classify":  # K7: its own schedule, any tile of 128-lane rows
        from repro_torch.kernels import classify as cl

        if tile % cl.LANES:
            return None
        sch = cl.schedule(key_bytes, k or 1)
        return cl.LANES, sch.threads, sch.smem_bytes
    if kind == "permute":  # K8: whole blocks of 128-lane rows
        from repro_torch.kernels import block_permute as bp

        if tile % bp.LANES or tile * key_bytes > bp.MAX_BLOCK_BYTES:
            return None
        return bp.LANES, bp.LANES, tile * key_bytes
    raise ValueError(f"unknown kernel kind {kind!r}")


def spec_candidates(kind: str, key_bytes: int, k: Optional[int] = None, *,
                    smem_bytes: Optional[int] = None, max_tile: int = 16384) -> tuple:
    """Descending power-of-two row counts (tile / lanes) that kernel
    ``kind`` launches with, its CTA's shared memory within ``smem_bytes``
    (the card's per-block limit by default)."""
    budget = HW["smem_per_block"] if smem_bytes is None else smem_bytes
    out = []
    tile = max_tile
    while tile >= _WARP:
        got = _shape(kind, key_bytes, k, tile)
        if got is not None and got[2] <= budget:
            out.append(tile // got[0])
        tile //= 2
    return tuple(out)


def launch_spec(kind: str, key_bytes: int, k: Optional[int] = None, *,
                n: Optional[int] = None, rows: Optional[int] = None,
                smem_bytes: Optional[int] = None) -> KernelLaunchSpec:
    """The launch of kernel ``kind``: ``rows`` pinned, or the largest
    candidate whose tile divides ``n`` (``rows == 0`` when none does; K7's
    wrapper takes ``classify.default_rows`` there, the histogram's shape).
    Counts ``launch.spec`` in ``obs`` as the reference does."""
    lanes = _lanes(kind)
    if rows is None and kind == "classify" and n is not None:
        from repro_torch.kernels import classify as cl

        rows = cl.default_rows(n, key_bytes, k or 1)
    if rows is None:
        rows = 0
        for cand in spec_candidates(kind, key_bytes, k, smem_bytes=smem_bytes):
            if n is None or n % (cand * lanes) == 0:
                rows = cand
                break
    from repro_torch import obs

    obs.count("launch.spec", kind=kind, rows=rows)  # rows=0: no tile divides n
    shp = _shape(kind, key_bytes, k, rows * lanes) if rows else None
    threads, smem = (shp[1], shp[2]) if shp else (0, 0)
    return KernelLaunchSpec(kind=kind, rows=rows, lanes=lanes, threads=threads,
                            smem_bytes=smem,
                            smem_budget=HW["smem_per_block"] if smem_bytes is None
                            else smem_bytes)


def _lanes(kind: str) -> int:
    return 128 if kind in ("classify", "permute") else _WARP


def classify_tile_rows(key_bytes: int, k: int, *, smem_bytes: Optional[int] = None) -> tuple:
    """Row-count candidates (128-lane rows) of the fused classify kernel K7:
    the ``kind="classify"`` projection of :func:`spec_candidates`."""
    return spec_candidates("classify", key_bytes, k, smem_bytes=smem_bytes)


def axis_link_bw(group_size: int, stride: int) -> float:
    """B/s per GPU of a collective over a mesh axis whose group is
    ``group_size`` ranks ``stride`` apart (ranks numbered node by node):
    NVLink when the group lies in one node, the assumed network rate when
    it spans nodes."""
    spans = group_size > 1 and (group_size - 1) * stride >= HW["node_gpus"]
    return HW["inter_node_bw"] if spans else HW["nvlink_bw"]


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: Dict[str, int]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float
    useful_ratio: float          # MODEL_FLOPS / global counted flops
    peak_mem_per_dev: Optional[float] = None
    note: str = ""
    raw_flops_per_dev: float = 0.0   # the traced (reduced) program as counted
    raw_bytes_per_dev: float = 0.0
    n_while: int = 0
    loop_trips: Dict[str, int] = field(default_factory=dict)
    bytes_min_per_dev: float = 0.0   # fusion-optimistic HBM traffic
    t_memory_min: float = 0.0
    bottleneck_min: str = ""         # bottleneck under optimistic memory
    coll_by_axis: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self))


def roofline_terms(*, arch: str, shape: str, mesh_name: str, chips: int, cost,
                   model_fl: float, axis_bw: Dict[str, float],
                   peak_mem: Optional[float] = None, note: str = "",
                   raw=None) -> RooflineReport:
    """``cost``: the step's ``op_cost.StepCost`` per rank (extrapolated over
    its loop trips); ``axis_bw``: B/s per GPU of each mesh axis
    (:func:`axis_link_bw`); ``raw``: the traced program's own cost."""
    coll = {k: int(v) for k, v in cost.coll.items()}
    cb = float(sum(coll.values()))
    t_c = cost.flops / HW["peak_flops"]
    t_m = cost.bytes / HW["hbm_bw"]
    t_m_min = cost.bytes_min / HW["hbm_bw"]
    t_x = sum(v / axis_bw.get(a, HW["inter_node_bw"]) for a, v in cost.coll_by_axis.items())
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bott = max(terms, key=terms.get)
    terms_min = {"compute": t_c, "memory": t_m_min, "collective": t_x}
    bott_min = max(terms_min, key=terms_min.get)
    global_flops = cost.flops * chips
    raw = raw or cost
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_dev=cost.flops, bytes_per_dev=cost.bytes,
        coll_bytes_per_dev=cb, coll_breakdown=coll,
        t_compute=t_c, t_memory=t_m, t_collective=t_x, bottleneck=bott,
        model_flops=model_fl,
        useful_ratio=(model_fl / global_flops) if global_flops else 0.0,
        peak_mem_per_dev=peak_mem, note=note,
        raw_flops_per_dev=raw.flops, raw_bytes_per_dev=raw.bytes,
        n_while=cost.n_while, loop_trips=dict(cost.trips),
        bytes_min_per_dev=cost.bytes_min, t_memory_min=t_m_min,
        bottleneck_min=bott_min, coll_by_axis=dict(cost.coll_by_axis),
    )


def _param_count(cfg) -> float:
    """Total parameter count N (all experts counted; N_active separately)."""
    d, L, V = cfg.d_model, cfg.num_layers, cfg.vocab_size
    hd = cfg.hd
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "ssm":  # rwkv6
        tm = 5 * d * d + 2 * d * 64 + d  # r,k,v,g,o + lora
        cm = d * cfg.d_ff * 2 + d * d
        return L * (tm + cm) + emb
    attn = d * (cfg.num_heads * hd) * 2 + d * (cfg.num_kv_heads * hd) * 2
    if cfg.family == "moe":
        m = cfg.moe
        routed = m.num_experts * 3 * d * m.d_ff_expert
        shared = (3 * d * m.d_ff_shared) if m.num_shared else 0
        ffn = routed + shared + d * m.num_experts
    else:
        ffn = 3 * d * cfg.d_ff
    if cfg.family == "hybrid":
        s = cfg.ssm
        d_in = s.expand * d
        mamba = d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim) + d_in * d
        per = mamba + 3 * d * cfg.d_ff
        return L * per + attn + emb  # ONE shared attn block
    return L * (attn + ffn) + emb


def _active_param_count(cfg) -> float:
    if cfg.family != "moe":
        return _param_count(cfg)
    d, L = cfg.d_model, cfg.num_layers
    m = cfg.moe
    attn = d * (cfg.num_heads * cfg.hd) * 2 + d * (cfg.num_kv_heads * cfg.hd) * 2
    act = m.top_k * 3 * d * m.d_ff_expert + (3 * d * m.d_ff_shared if m.num_shared else 0)
    emb = cfg.vocab_size * d * 2
    return L * (attn + act + d * m.num_experts) + emb


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens processed.
    For decode shapes D = global_batch (one token per request);
    train counts fwd+bwd (6ND), prefill/decode fwd only (2ND)."""
    n_act = _active_param_count(cfg)
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n_act * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n_act * toks
    return 2.0 * n_act * shape.global_batch
