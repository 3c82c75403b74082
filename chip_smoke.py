#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero when it fails:

1. set-up: print the card's name and power limit, build every kernel from
   ``src/repro_torch/csrc`` with ``nvcc`` (into ``build/``);
2. each kernel against its plain torch twin on the card, bit for bit
   (``torch.equal``; tolerance 0, the outputs are integers):
   K1 at n = 2^24, k = 128 with pads on Uniform and TwoDup, K2 on the
   composite ids of a real level 1 at n = 2^24 (nb = 65,792) and on small
   nb, K3 on 2048 windows of W = 8192 with heavy duplicates;
3. the main path: ``repro_torch.ops.sort`` and ``argsort`` at n = 2^24 (two
   levels) and 2^17 (one level) on float32 Uniform with NaN and +-0.0
   sprinkled in and on int32 TwoDup, each held to ``torch.sort(stable=True)``
   of the port's encoded keys, with every kernel's launch count read just
   after and required to be > 0;
4. timing with CUDA events (median of several runs after warm-up): each
   kernel beside its plain twin and its bound, the whole sort beside
   ``torch.sort``;
5. a ``{"kernels": [...]}`` JSON line, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense, at the 700 W limit).  The kernels do
# 32-bit integer work outside the tensor cores; the data sheet gives no
# integer rate there, so the bound takes its 32-bit float rate, which no
# integer instruction mix exceeds: the bound stays a least time.
HBM_BYTES_PER_S = 3.35e12
OPS_32BIT_PER_S = 67e12

N_BIG = 1 << 24
N_SMALL = 1 << 17


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, warmup: int = 2, reps: int = 10) -> float:
    """Median device time of ``fn`` in ms, by CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over integer tensors or tuples of them."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(torch, g, w) for g, w in zip(got, want))
    if got.shape != want.shape:
        return -1
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def bound_ms(nbytes: float, ops: float):
    """The least time for the work: the larger of the byte and op times."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_32BIT_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_sort(torch, sort, x, top: int = 14) -> None:
    """Where one sort's time goes: device time per operation (torch.profiler)
    beside the host clock around the whole call."""
    from torch.profiler import ProfilerActivity, profile

    sort(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sort(x)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    # device-side kernel events only (the aten ops above them repeat their time)
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy_ms = sum(device_us(e) for e in events) / 1e3
    print(f"profile sort n={x.shape[0]}: wall {wall_ms:.3f} ms (host clock, profiler on), "
          f"kernels {busy_ms:.3f} ms in {sum(e.count for e in events)} launches, "
          f"idle share {1 - busy_ms / wall_ms:.3f}", flush=True)
    for e in events[:top]:
        print(f"  {device_us(e) / 1e3:9.3f} ms x{e.count:<4d} {e.key[:100]}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch import kernels, ops
        from repro_torch.core import ips4o, sampling
        from repro_torch.data.distributions import make_input
        from repro_torch.kernels import bitonic, level_fused as lf
    except ImportError as exc:
        fail(f"cannot import the port from {ROOT / 'src'}: {exc}")
    if any(m == "jax" or m.startswith(("jax.", "repro.")) or m == "repro"
           for m in sys.modules):
        fail("the port imported jax or repro")

    # ---- 1. set-up -----------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        fail(f"nvidia-smi: {exc}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} device {kind}", flush=True)
    t0 = time.time()
    try:
        logs = kernels.build_all()
    except RuntimeError as exc:
        fail(f"kernel build: {exc}")
    print(f"built {sorted(logs) or 'nothing (cached)'} in {time.time() - t0:.1f} s",
          flush=True)
    for stem, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {stem}: {line.strip()}")

    def encoded(dist, n, dtype, seed=1):
        return ops.keyspace.encode(torch.as_tensor(make_input(dist, n, dtype, seed=seed),
                                                   device=dev))

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = {}

    # ---- 2. kernels against their plain twins ------------------------------
    k = 128
    n_real = N_BIG - 12345
    for dist, dtype in (("Uniform", np.float32), ("TwoDup", np.int32)):
        keys = encoded(dist, n_real, dtype)
        keys = ips4o.pad_with_sentinel({"k": keys}, N_BIG)["k"]
        pos = torch.randint(0, n_real, (4 * k,), generator=gen, device=dev)
        spl = sampling.select_splitters(torch.sort(keys[pos]).values, k)
        raw_kernel = lf._level_tiles_kernel(keys, spl, k, n_real, lf.TILE)
        raw_plain = lf._level_tiles_plain(keys, spl, k, n_real, lf.TILE)
        got = lf.level_fused(keys, spl, k=k, n_real=n_real)
        want = lf.level_fused_plain(keys, spl, k=k, n_real=n_real)
        torch.cuda.synchronize()
        err = max(max_abs_err(torch, raw_kernel, raw_plain), max_abs_err(torch, got, want))
        print(f"K1 level_fused {dist} n={N_BIG} n_real={n_real} k={k}: "
              f"max_abs_err={err}", flush=True)
        if err != 0:
            fail(f"K1 differs from its plain twin on {dist}")
        rows.setdefault("level_fused", {"max_abs_err": 0})

    # K2 on the composite ids of a real level 1 (two-level plan at n = 2^24)
    cfg = ips4o.SortConfig()
    levels = ips4o.plan_levels(N_BIG, cfg)
    keys = encoded("Uniform", N_BIG, np.float32)
    level_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    arrays, off1, nb1, _ = ips4o.level_pass({"k": keys}, N_BIG, levels[0], cfg, level_gen)
    k2 = levels[1]
    comp = ips4o.composite_ids(arrays["k"], off1, nb1, N_BIG, k2, level_gen)
    nb2 = nb1 * 2 * k2
    k2_args = dict(nb=nb2, seg_offsets=off1, seg_width=2 * k2)
    k2_tile = ips4o._auto_tile(N_BIG, 2 * k2, cfg)
    got = lf.rank_hist(comp, tile=k2_tile, **k2_args)
    want = lf.rank_hist_plain(comp, tile=k2_tile, **k2_args)
    yard = torch.sort(comp, stable=True).indices
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    inverse_ok = torch.equal(got[0][yard].to(torch.int64),
                             torch.arange(N_BIG, device=dev))
    print(f"K2 rank_hist composite n={N_BIG} nb={nb2}: max_abs_err={err} "
          f"stable-argsort inverse {'equal' if inverse_ok else 'DIFFERS'}", flush=True)
    if err != 0 or not inverse_ok:
        fail("K2 differs on the level-2 composite ids")
    for nb in (3, 520):
        ids = torch.randint(0, nb, (1 << 20,), generator=gen, device=dev, dtype=torch.int32)
        err = max_abs_err(torch, lf.rank_hist(ids, nb=nb), lf.rank_hist_plain(ids, nb=nb))
        print(f"K2 rank_hist n={1 << 20} nb={nb}: max_abs_err={err}", flush=True)
        if err != 0:
            fail(f"K2 differs at nb={nb}")
    rows["rank_hist"] = {"max_abs_err": 0}

    # K3 on duplicate-heavy windows, where stability shows
    W, num_w = cfg.base_case, 2048
    wb = torch.sort(torch.randint(0, 64, (num_w, W), generator=gen, device=dev,
                                  dtype=torch.int32), dim=1).values
    wk = torch.randint(-3, 4, (num_w, W), generator=gen, device=dev, dtype=torch.int32)
    got = bitonic.sort_windows(wb, wk, nb=64)
    want = bitonic.sort_windows_plain(wb, wk, nb=64)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    print(f"K3 sort_windows {num_w} x {W} duplicate-heavy: max_abs_err={err}", flush=True)
    if err != 0:
        fail("K3 differs from its plain twin")
    rows["sort_windows"] = {"max_abs_err": 0}

    # ---- 3. the main path -------------------------------------------------
    def main_input(dist, n):
        if dist == "Uniform":
            x = make_input("Uniform", n, np.float32, seed=5)
            x[3::3] *= -1
            x[::1009] = np.nan
            x[1::1013] = -0.0
            x[2::1019] = 0.0
        else:
            x = make_input("TwoDup", n, np.int32, seed=5)
        return torch.as_tensor(x, device=dev)

    cases = [(n, d) for n in (N_BIG, N_SMALL) for d in ("Uniform", "TwoDup")]
    inputs = {c: main_input(c[1], c[0]) for c in cases}
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    results = {c: (ops.sort(x), ops.argsort(x)) for c, x in inputs.items()}
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"main path launches: {launches}", flush=True)
    for (n, dist), x in inputs.items():
        out, order = results[(n, dist)]
        enc = ops.keyspace.encode(x)
        yard = torch.sort(enc, stable=True)
        want = ops.keyspace.decode(yard.values, x.dtype)
        keys_ok = torch.equal(out.view(torch.int32), want.view(torch.int32))
        order_ok = torch.equal(order.to(torch.int64), yard.indices)
        nlev = len(ips4o.plan_levels(-(-n // cfg.base_case) * cfg.base_case, cfg))
        print(f"main {dist} n={n} levels={nlev}: sort {'ok' if keys_ok else 'WRONG'}, "
              f"argsort {'ok' if order_ok else 'WRONG'}", flush=True)
        if not (keys_ok and order_ok):
            fail(f"main path wrong on {dist} n={n}")
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
        rows[name]["launches"] = count

    # where the robustness fallback engages at n = 2^24 (the reference's
    # default sampling leaves some buckets above W/2 there)
    enc = ops.keyspace.encode(inputs[(N_BIG, "Uniform")])
    _, off, nb, pad_bucket = ips4o.partition_passes({"k": enc}, N_BIG, cfg, levels)
    big = ips4o._oversized(off, nb, cfg.base_case, pad_bucket)
    sizes = off[1:] - off[:-1]
    print(f"fallback at n={N_BIG}: {int(big.sum())} of {nb} buckets above W/2 hold "
          f"{int(sizes[big].sum())} keys, the largest "
          f"{int(sizes[big].max()) if bool(big.any()) else 0}", flush=True)

    # ---- 4. timing ------------------------------------------------------------
    # Op counts for the bounds, per element: K1 3 per search step (load,
    # compare, add) over log2(k) steps plus ~12 for eq, pad routing, the warp
    # match, the popcounts and the scan; K2 the same ~12 without the search;
    # K3 4 per compare-exchange (a 64-bit compare is two, the swap two).
    keys1 = encoded("Uniform", N_BIG, np.float32)
    spl1 = sampling.select_splitters(
        torch.sort(keys1[torch.randint(0, N_BIG, (4 * k,), generator=gen,
                                       device=dev)]).values, k)
    tiles1 = -(-N_BIG // lf.TILE)
    t = rows["level_fused"]
    t["ms"] = cuda_ms(torch, lambda: lf._level_tiles_kernel(keys1, spl1, k, N_BIG, lf.TILE))
    t["plain_ms"] = cuda_ms(torch, lambda: lf._level_tiles_plain(keys1, spl1, k, N_BIG,
                                                                 lf.TILE), reps=5)
    t["bound_ms"], t["bound_by"] = bound_ms(
        N_BIG * 12 + k * 4 + tiles1 * (2 * k + 1) * 4,
        N_BIG * (3 * (k.bit_length() - 1) + 12))
    t["library_ms"] = None
    t["wrapper_ms"] = cuda_ms(torch, lambda: lf.level_fused(keys1, spl1, k=k))

    items = lf._items(off1, N_BIG, k2_tile)
    t = rows["rank_hist"]
    t["ms"] = cuda_ms(torch, lambda: lf._rank_hist_slots_kernel(
        comp, 2 * k2, items[0], items[1], items[2], k2_tile))
    t["plain_ms"] = cuda_ms(torch, lambda: lf._rank_hist_slots_plain(
        comp, 2 * k2, items[0], items[2]), reps=5)
    num_items = items[0].shape[0]
    t["bound_ms"], t["bound_by"] = bound_ms(
        N_BIG * 12 + num_items * (3 + 2 * k2) * 4, N_BIG * 12)
    t["library_ms"] = None
    t["wrapper_ms"] = cuda_ms(torch, lambda: lf.rank_hist(comp, tile=k2_tile, **k2_args))

    t = rows["sort_windows"]
    t["ms"] = cuda_ms(torch, lambda: bitonic.sort_windows(wb, wk, nb=64))
    t["plain_ms"] = cuda_ms(torch, lambda: bitonic.sort_windows_plain(wb, wk, nb=64))
    log_w = W.bit_length() - 1
    compare_exchanges = (num_w * W // 2) * log_w * (log_w + 1) // 2
    t["bound_ms"], t["bound_by"] = bound_ms(num_w * W * 16, compare_exchanges * 4)
    packed = (wb.to(torch.int64) << 32) + (wk.to(torch.int64) + (1 << 31))
    t["library_ms"] = cuda_ms(torch, lambda: torch.sort(packed, dim=1, stable=True))

    whole = {}
    for (n, dist), x in inputs.items():
        whole[(n, dist)] = {
            "sort_ms": cuda_ms(torch, lambda: ops.sort(x), reps=5),
            "argsort_ms": cuda_ms(torch, lambda: ops.argsort(x), reps=5),
            "torch_sort_ms": cuda_ms(torch, lambda: torch.sort(x), reps=5),
            "torch_stable_argsort_ms": cuda_ms(
                torch, lambda: torch.sort(x, stable=True).indices, reps=5),
        }
    profile_sort(torch, ops.sort, inputs[(N_BIG, "Uniform")])
    for name, r in rows.items():
        print(f"time {name}: kernel {r['ms']:.4f} ms, with epilogue "
              f"{r.get('wrapper_ms', r['ms']):.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
              f"{r['library_ms']}", flush=True)
    for (n, dist), r in whole.items():
        print(f"time whole {dist} n={n}: " + ", ".join(
            f"{key} {v:.3f}" for key, v in r.items()), flush=True)

    # ---- 5. the kernels line and the result ----------------------------------
    meta = {
        "level_fused": ("src/repro_torch/csrc/level_fused.cu",
                        "src/repro/kernels/level_fused.py:160"),
        "rank_hist": ("src/repro_torch/csrc/level_fused.cu",
                      "src/repro/kernels/level_fused.py:311"),
        "sort_windows": ("src/repro_torch/csrc/bitonic.cu",
                         "src/repro/kernels/bitonic.py:72"),
    }
    line = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": r["launches"], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(f"card: {card}")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
