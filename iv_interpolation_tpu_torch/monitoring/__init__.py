"""Observability: logging, structured perf events and step metrics."""
