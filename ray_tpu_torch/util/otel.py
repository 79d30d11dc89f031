"""Opt-in OpenTelemetry bridge for the built-in tracing spans.

Reference parity: python/ray/util/tracing/tracing_helper.py:35-89 — the
reference wraps task submission/execution in OTel spans when the user
passes `_tracing_startup_hook` to ray.init. Here the built-in chrome-trace
spans (util/tracing.py) are the single instrumentation layer; calling
`enable_otel_tracing()` mirrors every completed span into an OTel tracer,
so any configured exporter (OTLP, console, in-memory for tests) sees task
submission/execution spans without a second instrumentation pass.
"""

from __future__ import annotations

from typing import Any, Optional

from ray_tpu_torch.util import tracing

_state = {"hook": None}


def enable_otel_tracing(tracer_provider: Optional[Any] = None) -> None:
    """Mirror framework spans into OpenTelemetry. Pass a TracerProvider to
    control exporting (defaults to the global provider)."""
    from opentelemetry import trace as ot_trace

    if _state["hook"] is not None:
        return
    provider = tracer_provider or ot_trace.get_tracer_provider()
    tracer = provider.get_tracer("ray_tpu_torch")

    def hook(event: dict) -> None:
        # translate the chrome-trace X event (perf_counter us) into a
        # real-time-anchored OTel span
        import time

        end_ns = time.time_ns()
        start_ns = end_ns - int(event["dur"] * 1000)
        span = tracer.start_span(event["name"], start_time=start_ns)
        span.set_attribute("category", event.get("cat", ""))
        for k, v in (event.get("args") or {}).items():
            if isinstance(v, (str, int, float, bool)):
                span.set_attribute(k, v)
        span.end(end_time=end_ns)

    _state["hook"] = hook
    tracing.add_span_hook(hook)


def disable_otel_tracing() -> None:
    if _state["hook"] is not None:
        tracing.remove_span_hook(_state["hook"])
        _state["hook"] = None
