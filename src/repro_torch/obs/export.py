"""Exporters: JSONL event log, Chrome trace-event file, human summary.

Counterpart of ``repro.obs.export``; the text is the reference's, key for
key and line for line (headers included), so the same tools read both.
The one added field is a span's ``device_ms`` (the CUDA-event time between
its entry and exit), present only where events were recorded:

* :func:`export_jsonl`: one JSON object per line, ``type`` in ``{span,
  event, counter, gauge, histogram}``; span lines gain ``device_ms``;
* :func:`export_chrome_trace`: the Chrome trace-event format
  (``{"traceEvents": [...]}``, complete ``ph:"X"`` events in µs; a span's
  ``device_ms`` joins its args).  Open in Perfetto or ``chrome://tracing``;
* :func:`summary`: a plain-text table of span stats, counters, gauges and
  histogram summaries; span rows gain ``device=...ms`` where recorded;
* :func:`timed_min`: min-of-k measurement through the tracer, each
  iteration a recorded span with the device synchronized around it.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.obs import metrics, tracer

__all__ = [
    "export_chrome_trace",
    "export_jsonl",
    "span_stats",
    "summary",
    "timed_min",
]


def _snapshot(rec: tracer.Recorder) -> Dict[str, Any]:
    rec.resolve_device_times()
    with rec._lock:
        return {"spans": list(rec.spans), "events": list(rec.events)}


def span_stats(rec: Optional[tracer.Recorder] = None) -> Dict[str, Dict[str, float]]:
    """Per-name aggregates over recorded spans: count, total/min/max ns,
    and ``device_ms`` (the sum) where CUDA events were recorded."""
    rec = rec or tracer.recorder()
    out: Dict[str, Dict[str, float]] = {}
    for s in _snapshot(rec)["spans"]:
        a = out.setdefault(
            s["name"], {"count": 0, "total_ns": 0, "min_ns": None, "max_ns": 0}
        )
        d = s["dur_ns"]
        a["count"] += 1
        a["total_ns"] += d
        a["min_ns"] = d if a["min_ns"] is None else min(a["min_ns"], d)
        a["max_ns"] = max(a["max_ns"], d)
        if "device_ms" in s:
            a["device_ms"] = a.get("device_ms", 0.0) + s["device_ms"]
    return out


def export_jsonl(path: str, rec: Optional[tracer.Recorder] = None) -> None:
    """Write every span, event and metric series as one JSON line each."""
    rec = rec or tracer.recorder()
    snap = _snapshot(rec)
    mets = metrics.metrics_snapshot(rec)
    with open(path, "w") as fh:
        for s in snap["spans"]:
            line = {
                "type": "span", "name": s["name"], "id": s["id"],
                "parent": s["parent"], "depth": s["depth"],
                "ts_us": s["t0_ns"] / 1e3, "dur_us": s["dur_ns"] / 1e3,
                "tid": s["tid"], "attrs": s["attrs"],
            }
            if "device_ms" in s:
                line["device_ms"] = s["device_ms"]
            fh.write(json.dumps(line) + "\n")
        for e in snap["events"]:
            fh.write(json.dumps({
                "type": "event", "name": e["name"],
                "ts_us": e["t_ns"] / 1e3, "attrs": e["attrs"],
            }) + "\n")
        for kind in ("counter", "gauge"):
            for m in mets[kind + "s"]:
                fh.write(json.dumps(dict(m, type=kind)) + "\n")
        for m in mets["histograms"]:
            fh.write(json.dumps(dict(m, type="histogram")) + "\n")


def export_chrome_trace(path: str, rec: Optional[tracer.Recorder] = None) -> None:
    """Write a Chrome trace-event JSON viewable in Perfetto.

    Spans become complete (``ph:"X"``) events with µs timestamps; point
    events become instants (``ph:"i"``); final counter values become
    ``ph:"C"`` samples at the trace end.
    """
    rec = rec or tracer.recorder()
    snap = _snapshot(rec)
    mets = metrics.metrics_snapshot(rec)
    tids = {}
    evs: List[Dict[str, Any]] = [{
        "ph": "M", "name": "process_name", "pid": 0,
        "args": {"name": "repro.obs"},
    }]
    end_us = 0.0
    for s in snap["spans"]:
        tid = tids.setdefault(s["tid"], len(tids))
        ts = s["t0_ns"] / 1e3
        dur = s["dur_ns"] / 1e3
        end_us = max(end_us, ts + dur)
        args = s["attrs"]
        if "device_ms" in s:
            args = dict(args, device_ms=s["device_ms"])
        evs.append({
            "name": s["name"], "cat": "span", "ph": "X",
            "ts": ts, "dur": dur, "pid": 0, "tid": tid,
            "args": args,
        })
    for e in snap["events"]:
        ts = e["t_ns"] / 1e3
        end_us = max(end_us, ts)
        evs.append({
            "name": e["name"], "cat": "event", "ph": "i", "s": "p",
            "ts": ts, "pid": 0, "tid": 0, "args": e["attrs"],
        })
    for m in mets["counters"]:
        label = ",".join(f"{k}={v}" for k, v in sorted(m["labels"].items()))
        name = m["name"] + (f"{{{label}}}" if label else "")
        evs.append({
            "name": name, "cat": "metric", "ph": "C",
            "ts": end_us, "pid": 0, "tid": 0,
            "args": {"value": m["value"]},
        })
    with open(path, "w") as fh:
        json.dump({"traceEvents": evs, "displayTimeUnit": "ms"}, fh)


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def summary(rec: Optional[tracer.Recorder] = None) -> str:
    """Human-readable table of spans, counters, gauges, histograms."""
    rec = rec or tracer.recorder()
    stats = span_stats(rec)
    mets = metrics.metrics_snapshot(rec)
    n_events = len(_snapshot(rec)["events"])
    lines = ["== repro.obs summary =="]
    if stats:
        lines.append(f"-- spans ({sum(a['count'] for a in stats.values())}) --")
        w = max(len(n) for n in stats)
        for name in sorted(stats):
            a = stats[name]
            row = (
                f"  {name:<{w}}  count={a['count']:<5d} "
                f"min={a['min_ns'] / 1e3:>10.1f}us "
                f"total={a['total_ns'] / 1e6:>10.2f}ms"
            )
            if "device_ms" in a:
                row += f" device={a['device_ms']:>10.2f}ms"
            lines.append(row)
    if mets["counters"]:
        lines.append(f"-- counters ({len(mets['counters'])}) --")
        for m in mets["counters"]:
            lines.append(
                f"  {m['name']}{_fmt_labels(m['labels'])} = {m['value']:g}"
            )
    if mets["gauges"]:
        lines.append(f"-- gauges ({len(mets['gauges'])}) --")
        for m in mets["gauges"]:
            lines.append(
                f"  {m['name']}{_fmt_labels(m['labels'])} = {m['value']:g}"
            )
    if mets["histograms"]:
        lines.append(f"-- histograms ({len(mets['histograms'])}) --")
        for m in mets["histograms"]:
            mean = m["sum"] / max(m["count"], 1)
            lines.append(
                f"  {m['name']}{_fmt_labels(m['labels'])} "
                f"count={m['count']} mean={mean:g} "
                f"min={m['min']:g} max={m['max']:g}"
            )
    if n_events:
        lines.append(f"-- events ({n_events}) --")
        for e in _snapshot(rec)["events"]:
            lines.append(f"  {e['name']} {e['attrs']}")
    if len(lines) == 1:
        lines.append("  (empty)")
    return "\n".join(lines)


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed_min(
    name: str,
    fn: Callable[[], Any],
    *,
    iters: int = 9,
    warmup: int = 2,
    recorder: Optional[tracer.Recorder] = None,
    **attrs: Any,
) -> float:
    """Min-of-``iters`` wall time (seconds) of ``fn()``, with every CUDA
    device synchronized before and after each call.

    Each iteration is recorded as a span named ``name`` (attrs carry the
    iteration index), into ``recorder`` or the global recorder: this path
    records even while obs is globally disabled, so benches always leave
    a trace of how a number was produced.
    """
    rec = tracer.recorder() if recorder is None else recorder
    for _ in range(max(0, warmup)):
        fn()
        _sync()
    best = float("inf")
    for i in range(max(1, iters)):
        _sync()
        with tracer._Span(rec, name, dict(attrs, iter=i)):
            t0 = time.perf_counter_ns()
            fn()
            _sync()
            dt = time.perf_counter_ns() - t0
        best = min(best, dt)
    return best / 1e9
