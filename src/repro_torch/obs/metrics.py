"""Metrics registry: counters, gauges, histograms, from host values and
from device tensors.

Counterpart of ``repro.obs.metrics`` (DESIGN.md §12).  Two families of
hooks:

* **host values** (``count`` / ``gauge`` / ``observe``): called from plain
  Python (plan-cache lookups, router decisions, stream spills).  With obs
  disabled each is a single dict lookup and return;

* **device tensors** (``jit_count`` / ``jit_observe`` / ``jit_event``):
  the reference stages these inside jit as debug callbacks; the port has
  no jit, so they keep the names and take the tensors directly.  With
  obs enabled each makes ONE host read of all its tensors (``.tolist()``
  of one concatenation: a sync with the device) and honours ``gate``.
  With obs disabled each returns before touching a tensor: no read, no
  sync, no launch.

``gate=`` takes a bool or a bool tensor: the hook records only when it is
true, e.g. on the first rank of a process group for values every rank of
the group holds (the reference's lead-shard gate under ``shard_map``).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.obs import tracer

__all__ = [
    "count",
    "counter_value",
    "gauge",
    "hist_values",
    "jit_count",
    "jit_event",
    "jit_observe",
    "metrics_snapshot",
    "observe",
]

_LOG = logging.getLogger("repro_torch.obs")


def _labels_key(labels: Dict[str, Any]) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# -- host values ----------------------------------------------------------

def count(name: str, value: float = 1, **labels: Any) -> None:
    """Increment counter ``name`` (one series per distinct label set)."""
    if not tracer._STATE["enabled"]:
        return
    tracer._RECORDER.add_count(name, float(value), _labels_key(labels))


def gauge(name: str, value: float, **labels: Any) -> None:
    """Set gauge ``name`` to its latest value."""
    if not tracer._STATE["enabled"]:
        return
    tracer._RECORDER.set_gauge(name, float(value), _labels_key(labels))


def observe(name: str, value: float, **labels: Any) -> None:
    """Record one observation into histogram ``name``."""
    if not tracer._STATE["enabled"]:
        return
    tracer._RECORDER.add_observation(name, float(value), _labels_key(labels))


# -- device tensors (read only while obs is enabled) ----------------------

def _host(values: Sequence[Any]) -> List[Any]:
    """Every value as host Python data, the tensors among them by one
    ``.tolist()`` of their concatenation (float64: exact for the counts
    and fills read here), each returned as a flat list of its own kind
    (bool, int or float, as ``numpy``'s ``tolist`` would give)."""
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    flat: List[float] = []
    if tensors:
        dev = tensors[0].device
        flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64)
                          for t in tensors]).tolist()
    out, at = [], 0
    for v in values:
        if not isinstance(v, torch.Tensor):
            out.append([v])
            continue
        part = flat[at:at + v.numel()]
        at += v.numel()
        if v.dtype == torch.bool:
            part = [bool(x) for x in part]
        elif not (v.dtype.is_floating_point or v.dtype.is_complex):
            part = [int(x) for x in part]
        out.append(part)
    return out


def _gate_open(gate: List[Any]) -> bool:
    return all(bool(g) for g in gate)


def jit_count(name: str, value: Any, **labels: Any) -> None:
    """Counter increment by the sum of a tensor (one host read when obs is
    enabled; nothing read when disabled)."""
    if not tracer._STATE["enabled"]:
        return
    (vals,) = _host([value])
    tracer._RECORDER.add_count(name, float(sum(vals)), _labels_key(labels))


def jit_observe(
    name: str, value: Any, *, gate: Any = None, **labels: Any
) -> None:
    """Histogram observation(s) from a tensor's elements; ``gate`` (bool
    or bool tensor) suppresses recording, e.g. on every rank but the
    first of a group.  One host read of gate and value together when obs
    is enabled; nothing read when disabled."""
    if not tracer._STATE["enabled"]:
        return
    g, vals = _host([True if gate is None else gate, value])
    if not _gate_open(g):
        return
    key = _labels_key(labels)
    for x in vals:
        tracer._RECORDER.add_observation(name, float(x), key)


def jit_event(
    name: str,
    payload: Dict[str, Any],
    *,
    gate: Any = None,
    warn: Optional[str] = None,
    **labels: Any,
) -> None:
    """Point event: ``payload`` maps attr names to tensors (recorded as the
    event's attrs, a scalar for one element, else a list, next to the
    static ``labels``); ``warn`` also logs one line on the
    ``repro_torch.obs`` logger when the gated event fires.  One host read
    of the gate and the payload together when obs is enabled; nothing read
    when disabled."""
    if not tracer._STATE["enabled"]:
        return
    names = tuple(payload)
    host = _host([True if gate is None else gate, *payload.values()])
    if not _gate_open(host[0]):
        return
    attrs: Dict[str, Any] = {str(k): v for k, v in labels.items()}
    for k, vals in zip(names, host[1:]):
        attrs[k] = vals[0] if len(vals) == 1 else vals
    tracer._RECORDER.add_event(name, attrs)
    if warn:
        _LOG.warning("%s (%s)", warn, ", ".join(f"{k}={attrs[k]}" for k in names))


# -- read side ------------------------------------------------------------

def _match(key: tuple, name: str, labels: Dict[str, Any]) -> bool:
    if key[0] != name:
        return False
    have = dict(key[1])
    return all(have.get(str(k)) == str(v) for k, v in labels.items())


def counter_value(name: str, **labels: Any) -> float:
    """Sum of all counter series matching ``name`` and the given label
    subset (no labels: all series of that name)."""
    rec = tracer._RECORDER
    with rec._lock:
        items = list(rec.counters.items())
    return sum(v for k, v in items if _match(k, name, labels))


def hist_values(name: str, **labels: Any) -> List[float]:
    """Concatenated retained observations of matching histogram series."""
    rec = tracer._RECORDER
    with rec._lock:
        items = [(k, list(h["values"])) for k, h in rec.hists.items()]
    out: List[float] = []
    for k, vals in items:
        if _match(k, name, labels):
            out.extend(vals)
    return out


def metrics_snapshot(rec: Optional[tracer.Recorder] = None) -> Dict[str, Any]:
    """JSON-ready snapshot of every metric series."""
    rec = rec or tracer._RECORDER
    with rec._lock:
        return {
            "counters": [
                {"name": k[0], "labels": dict(k[1]), "value": v}
                for k, v in sorted(rec.counters.items())
            ],
            "gauges": [
                {"name": k[0], "labels": dict(k[1]), "value": v}
                for k, v in sorted(rec.gauges.items())
            ],
            "histograms": [
                {"name": k[0], "labels": dict(k[1]),
                 "count": h["count"], "sum": h["sum"],
                 "min": h["min"], "max": h["max"],
                 "values": list(h["values"])}
                for k, h in sorted(rec.hists.items())
            ],
        }
