"""Observability for the port: per-operator metrics (``metrics.py``)."""
