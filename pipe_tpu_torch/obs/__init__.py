"""Observability: the process-local metrics registry (``telemetry``) and the
JSONL event log (``events``), copied from ``pipe_tpu/obs``."""
