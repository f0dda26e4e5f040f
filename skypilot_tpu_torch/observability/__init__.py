"""The port's observability plane: metrics, spans and live telemetry.

The port's copy of `skypilot_tpu/observability/`, stdlib only:

- `metrics`: thread-safe Counter/Gauge/Histogram registry with
  Prometheus text exposition (the server's /metrics).
- `tracing`: a contextvar request ID per request.
- `spans`: request span trees under one trace ID, W3C `traceparent`
  propagation and the flight recorder (/internal/trace).
- `instruments`: the skytpu_* catalog the engine, server, train loop
  and HF import report through, and the HTTP middleware.
- `timeseries` and `watchdog`: the in-process time-series ring
  (/internal/timeseries) and the live SLO rules over it
  (/internal/alerts).
- `top` and `trace_dump`: stdlib HTTP clients of those endpoints.
"""
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import tracing

__all__ = ['metrics', 'tracing']
