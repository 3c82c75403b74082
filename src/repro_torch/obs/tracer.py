"""Span tracer: host-side structured timing, CUDA-event device timing and
profiler pass-through.

Counterpart of ``repro.obs.tracer`` (DESIGN.md §12).  ``trace(name,
**attrs)`` returns a context manager that records a span (name, wall-clock
duration, parent span, static attributes) into the process-global
:class:`Recorder`.  The port runs eagerly, so every span measures real
work: the host time the calls inside it took to issue, and, where CUDA is
initialised, the device time between two ``torch.cuda.Event``s recorded
on the current stream at entry and exit.  The device time is read lazily,
by :func:`repro_torch.obs.span_stats` and the exporters, never at exit,
so a span adds no host sync; ``block`` at an op boundary makes the host
time cover the device work too.

Every span also enters ``torch.profiler.record_function(name)`` (the
counterpart of the reference's ``TraceAnnotation``/``named_scope``), so
the span names land in ``torch.profiler`` traces.

Disabled (the default; enable with ``REPRO_OBS=1`` or
``obs.enabled(True)``), ``trace`` returns one shared null span: no lock,
no clock read, no CUDA call.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = [
    "Recorder",
    "block",
    "enabled",
    "events",
    "recorder",
    "reset",
    "trace",
]

_TRUTHY = ("1", "true", "True", "yes", "on")
_STATE = {"enabled": os.environ.get("REPRO_OBS", "") in _TRUTHY}


def enabled(value: Optional[bool] = None) -> bool:
    """Get (no args) or set the global obs enable flag.  The port has no
    traced programs to re-trace: a toggle takes effect at the next call."""
    if value is not None:
        _STATE["enabled"] = bool(value)
    return _STATE["enabled"]


class Recorder:
    """Accumulates spans, point events and metric aggregates.

    One process-global instance backs the module-level API; explicit
    instances can be passed to ``trace(..., recorder=...)`` /
    ``timed_min(..., recorder=...)`` for isolated measurement.

    Metric keys are ``(name, ((label, value), ...))`` with labels sorted,
    so the same name with different labels forms distinct series.  The
    CUDA events of a span wait in ``device_events`` (by span id) until
    :meth:`resolve_device_times` turns them into the span's ``device_ms``.
    """

    #: cap on raw values retained per histogram series (count/sum/min/max
    #: keep aggregating past it)
    HIST_CAP = 4096

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self.origin_ns = time.perf_counter_ns()
        self.spans: List[Dict[str, Any]] = []
        self.events: List[Dict[str, Any]] = []
        self.counters: Dict[tuple, float] = {}
        self.gauges: Dict[tuple, float] = {}
        self.hists: Dict[tuple, Dict[str, Any]] = {}
        self.device_events: Dict[int, Tuple[Any, Any]] = {}

    def clear(self) -> None:
        with self._lock:
            self._next_id = 0
            self.origin_ns = time.perf_counter_ns()
            self.spans.clear()
            self.events.clear()
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()
            self.device_events.clear()

    # -- span bookkeeping -------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
        return i

    def add_span(self, span: Dict[str, Any], device_events: Any = None) -> None:
        with self._lock:
            self.spans.append(span)
            if device_events is not None:
                self.device_events[span["id"]] = device_events

    def resolve_device_times(self) -> None:
        """Give every span whose CUDA events were recorded its ``device_ms``
        (the end event is waited for here: the only sync obs makes)."""
        with self._lock:
            pending, self.device_events = self.device_events, {}
            spans = {s["id"]: s for s in self.spans if s["id"] in pending}
        for sid, (start, end) in pending.items():
            end.synchronize()
            if sid in spans:
                spans[sid]["device_ms"] = start.elapsed_time(end)

    # -- metrics (called from metrics.py) ---------------------------------
    def add_event(self, name: str, attrs: Dict[str, Any]) -> None:
        ev = {
            "name": name,
            "t_ns": time.perf_counter_ns() - self.origin_ns,
            "attrs": attrs,
        }
        with self._lock:
            self.events.append(ev)

    def add_count(self, name: str, value: float, labels: tuple) -> None:
        key = (name, labels)
        with self._lock:
            self.counters[key] = self.counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, labels: tuple) -> None:
        with self._lock:
            self.gauges[(name, labels)] = value

    def add_observation(self, name: str, value: float, labels: tuple) -> None:
        key = (name, labels)
        with self._lock:
            h = self.hists.get(key)
            if h is None:
                h = self.hists[key] = {
                    "count": 0, "sum": 0.0, "min": value, "max": value,
                    "values": [],
                }
            h["count"] += 1
            h["sum"] += value
            h["min"] = min(h["min"], value)
            h["max"] = max(h["max"], value)
            if len(h["values"]) < self.HIST_CAP:
                h["values"].append(value)


_RECORDER = Recorder()


def recorder() -> Recorder:
    """The process-global recorder (stable identity across ``reset``)."""
    return _RECORDER


def reset() -> None:
    """Clear the global recorder in place (identity preserved)."""
    _RECORDER.clear()


def events(name: Optional[str] = None) -> List[Dict[str, Any]]:
    """Recorded point events, optionally filtered by name."""
    with _RECORDER._lock:
        evs = list(_RECORDER.events)
    return evs if name is None else [e for e in evs if e["name"] == name]


class _NullSpan:
    """Shared no-op span returned while obs is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


def _cuda_event() -> Optional[Any]:
    """A timing event recorded on the current stream, where CUDA is
    initialised (a span never initialises CUDA itself)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("rec", "name", "attrs", "id", "parent", "depth", "t0",
                 "_fn", "_ev0")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]):
        self.rec = rec
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1].id if stack else None
        self.depth = len(stack)
        self.id = rec._new_id()
        stack.append(self)
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        self._ev0 = _cuda_event()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        dur = time.perf_counter_ns() - self.t0
        ev1 = _cuda_event() if self._ev0 is not None else None
        self._fn.__exit__(exc_type, exc, tb)
        rec = self.rec
        stack = rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        rec.add_span({
            "id": self.id,
            "parent": self.parent,
            "name": self.name,
            "t0_ns": self.t0 - rec.origin_ns,
            "dur_ns": dur,
            "depth": self.depth,
            "tid": threading.get_ident(),
            "attrs": dict(self.attrs),
        }, None if ev1 is None else (self._ev0, ev1))
        return False


def trace(name: str, *, recorder: Optional[Recorder] = None, **attrs: Any):
    """Span context manager: ``with obs.trace("level_pass", level=1): ...``.

    With obs disabled and no explicit ``recorder``, returns the shared
    no-op span.  An explicit ``recorder`` records regardless of the global
    flag: that is how :func:`repro_torch.obs.timed_min` measures with obs
    off.
    """
    rec = recorder
    if rec is None:
        if not _STATE["enabled"]:
            return _NULL_SPAN
        rec = _RECORDER
    return _Span(rec, name, attrs)


def _sync_leaves(x: Any) -> None:
    """Wait for the current stream of every CUDA device among ``x``'s
    tensor leaves."""
    devices = {leaf.device for leaf in pytree.tree_leaves(x)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in devices:
        torch.cuda.current_stream(d).synchronize()


def block(x: Any) -> Any:
    """Wait for the current stream of ``x``'s device(s) when obs is enabled
    and ``x`` (a tensor or a pytree of them) is on CUDA; ``x`` as it is.

    Used at op boundaries so an enclosing span's host time covers the
    device work, without adding a host sync when obs is off."""
    if _STATE["enabled"]:
        _sync_leaves(x)
    return x
