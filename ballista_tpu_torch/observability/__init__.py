"""Observability for the port: per-operator metrics (``metrics.py``) and
the span/event tracer (``tracing.py``, copied from the JAX package)."""

from .tracing import trace_event, trace_span  # noqa: F401
