"""Observability of the port: metrics, traces, exporters.

The same three pieces as the reference's ``repro/obs/__init__.py``,
re-exported under the same names, each a copy of the reference's
module (numpy and the standard library only):

* ``metrics`` — the thread-safe ``MetricsRegistry`` of counters,
  gauges, labeled and array counters and log-bucketed ``Histogram``s
  that the serving runtime records into;
* ``trace`` — spans with a near-zero-cost disabled path, ``timed`` and
  ``event``;
* ``export`` — the Chrome-trace writer and loader, atomic metrics
  snapshots with a Prometheus text sidecar, the ``MetricsServer``
  (``serve --metrics-port``) and the worst-N ``SlowQueryLog``.
"""
from .export import (MetricsExporter, MetricsServer, SlowQueryLog,
                     load_chrome_trace, write_chrome_trace,
                     write_snapshot)
from .metrics import (ArrayCounter, Counter, Gauge, Histogram,
                      HistogramSnapshot, LabeledCounter,
                      MetricsRegistry)
from .trace import Tracer, event, get_tracer, span, timed

__all__ = [
    "ArrayCounter", "Counter", "Gauge", "Histogram",
    "HistogramSnapshot", "LabeledCounter", "MetricsExporter",
    "MetricsRegistry", "MetricsServer", "SlowQueryLog", "Tracer",
    "event", "get_tracer", "load_chrome_trace", "span", "timed",
    "write_chrome_trace", "write_snapshot",
]
