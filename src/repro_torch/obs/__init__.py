"""repro_torch.obs: structured tracing, metrics and profiling hooks.

Counterpart of ``repro.obs`` (DESIGN.md §12): low-overhead,
**off-by-default** observability for the port's sort engine.  Enable with
``REPRO_OBS=1`` in the environment or ``obs.enabled(True)`` at runtime.
While disabled every hook is a no-op: ``trace`` returns one shared null
span, the metric hooks return at once, and no hook reads a tensor,
synchronizes the card or launches anything (``tests/test_torch_obs.py``
holds the aten ops of a sort to those with the hooks replaced by no-ops).

Quickstart::

    from repro_torch import obs, ops

    obs.enabled(True)
    out = ops.sort(x)                      # spans + metrics recorded
    print(obs.summary())                   # human table
    obs.export_jsonl("sort.jsonl")         # machine archive
    obs.export_chrome_trace("sort.trace.json")  # open in Perfetto

Three layers:

* **Tracer**: ``obs.trace(name, **attrs)`` spans with host timing and,
  where CUDA is initialised, device timing by CUDA events (read lazily,
  at export), plus ``torch.profiler.record_function`` pass-through so the
  span names land in profiles; ``obs.block`` waits for the card at op
  boundaries, only when enabled.
* **Metrics**: counters/gauges/histograms from host values (``count`` /
  ``gauge`` / ``observe``) and from device tensors (``jit_count`` /
  ``jit_observe`` / ``jit_event``: one host read each, only when enabled).
* **Exporters**: ``export_jsonl``, ``export_chrome_trace``, ``summary``
  and ``timed_min``.

Instrumented call sites: ``core/ips4o.py`` (per-level spans,
bucket-imbalance / base-case / fallback stats), ``ops/sort.py`` and
``ops/topk.py`` (op spans), ``ops/plan.py`` (plan-cache hit/miss/autotune,
classifier races), ``classify/router.py`` (routing decisions),
``stream/api.py`` (spill bytes, tournament rounds) and ``dist/``
(re-split rounds, collective volume, overflow events, overlap).
"""
from repro_torch.obs.export import (
    export_chrome_trace,
    export_jsonl,
    span_stats,
    summary,
    timed_min,
)
from repro_torch.obs.metrics import (
    count,
    counter_value,
    gauge,
    hist_values,
    jit_count,
    jit_event,
    jit_observe,
    metrics_snapshot,
    observe,
)
from repro_torch.obs.tracer import (
    Recorder,
    block,
    enabled,
    events,
    recorder,
    reset,
    trace,
)

__all__ = [
    "Recorder",
    "block",
    "count",
    "counter_value",
    "enabled",
    "events",
    "export_chrome_trace",
    "export_jsonl",
    "gauge",
    "hist_values",
    "jit_count",
    "jit_event",
    "jit_observe",
    "metrics_snapshot",
    "observe",
    "recorder",
    "reset",
    "span_stats",
    "summary",
    "timed_min",
    "trace",
]
