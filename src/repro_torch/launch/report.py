"""Aggregate dry-run JSON rows into the roofline table.

Counterpart of ``repro.launch.report`` with the same columns.  The
``frac`` column (useful compute time over the modelled step time) divides
the model flops by ``roofline.HW["peak_flops"]`` (the H100's dense bf16
rate), where the reference writes its TPU's rate in.  Every time in the
table is modelled, for NVIDIA H100 80GB HBM3 cards at 700 W; none is
measured.

  PYTHONPATH=src python -m repro_torch.launch.report results/dryrun [--md | --grid]

(``--grid``: one markdown row per arch, one column per shape.)
"""
from __future__ import annotations

import glob
import json
import os
import sys

from repro_torch.launch.roofline import HW


def load(dirname: str):
    rows = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            d = json.load(fh)
        d["_file"] = os.path.basename(f)
        rows.append(d)
    return rows


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    return f"{x * 1e3:.1f}ms"


def table(rows, md=False):
    hdr = ["arch", "shape", "mesh", "t_comp", "t_mem", "t_mem_min", "t_coll",
           "bott(min)", "useful", "peakGB", "frac"]
    out = []
    for d in rows:
        if d.get("status") == "skipped":
            out.append([d["arch"], d["shape"], d.get("mesh", ""), "skip:full-attn",
                        "", "", "", "", "", "", ""])
            continue
        if d.get("status") != "ok":
            out.append([d["arch"], d["shape"], d.get("mesh", ""),
                        "ERROR", "", "", "", "", "", "", ""])
            continue
        r = d["roofline"]
        tc, tm, tmm, tx = (r["t_compute"], r["t_memory"],
                           r.get("t_memory_min", 0.0), r["t_collective"])
        peak = (d.get("memory", {}).get("peak_memory_in_bytes")
                or d.get("memory", {}).get("argument_size_in_bytes", 0))
        # roofline fraction: useful-compute time over the modelled step time
        # (optimistic memory model)
        model_t = r["model_flops"] / r["chips"] / HW["peak_flops"]
        frac = model_t / max(tc, tmm, tx) if max(tc, tmm, tx) else 0.0
        out.append([
            d["arch"], d["shape"], d["mesh"], fmt_s(tc), fmt_s(tm), fmt_s(tmm),
            fmt_s(tx), r.get("bottleneck_min", r["bottleneck"]),
            f"{r['useful_ratio']:.2f}", f"{peak / 2**30:.1f}",
            f"{frac:.3f}",
        ])
    w = [max(len(str(r[i])) for r in [hdr] + out) for i in range(len(hdr))]
    sep = " | " if md else "  "
    head = sep.join(str(h).ljust(w[i]) for i, h in enumerate(hdr))
    lines = [("| " + head + " |") if md else head]
    if md:
        lines.append("|" + "|".join("-" * (x + 2) for x in w) + "|")
    for r in out:
        line = sep.join(str(c).ljust(w[i]) for i, c in enumerate(r))
        lines.append(("| " + line + " |") if md else line)
    return "\n".join(lines)


def grid(rows) -> str:
    """One markdown row per arch, one column per shape: the modelled step
    (the largest of t_comp, t_mem_min and t_coll), its bottleneck and
    ``frac``, or the skip."""
    shapes = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    cell = {}
    for d in rows:
        if d.get("status") == "skipped":
            cell[d["arch"], d["shape"]] = "skip: full-attn"
        elif d.get("status") != "ok":
            cell[d["arch"], d["shape"]] = "ERROR"
        else:
            r = d["roofline"]
            t = max(r["t_compute"], r.get("t_memory_min", 0.0), r["t_collective"])
            frac = r["model_flops"] / r["chips"] / HW["peak_flops"] / t if t else 0.0
            cell[d["arch"], d["shape"]] = (f"{fmt_s(t)} {r.get('bottleneck_min', r['bottleneck'])}"
                                           f" {frac:.3f}")
    archs = list(dict.fromkeys(d["arch"] for d in rows))
    lines = ["| arch | " + " | ".join(shapes) + " |", "|---" * (len(shapes) + 1) + "|"]
    for a in archs:
        lines.append(f"| {a} | " + " | ".join(cell.get((a, s), "") for s in shapes) + " |")
    return "\n".join(lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    d = args[0] if args else "results/dryrun"
    md = "--md" in argv
    rows = load(d)
    pods = {}
    for r in rows:
        pods.setdefault("2pod" if "2pod" in r["_file"] else "1pod", []).append(r)
    for pod, rs in sorted(pods.items()):
        print(f"\n=== {pod} ===")
        print(grid(rs) if "--grid" in argv else table(rs, md=md))


if __name__ == "__main__":
    main()
