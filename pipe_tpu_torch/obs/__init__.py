"""Observability: metrics registry and step reports (``telemetry``), the
JSONL event log (``events``), profiler ranges and traces, bubble measurement
and per-stage timelines (``meters``), TensorBoard scalars (``tb_writer``).
Counterpart of ``pipe_tpu/obs`` without the fleet observer (ROADMAP.md A.7)
and the xplane reader (torch writes Chrome traces, which ``meters`` reads)."""

from .events import EventLog, NULL_EVENT_LOG, NullEventLog, SPAN_KINDS
from .meters import (BubbleMeter, device_memory_report, measured_bubble_slope,
                     measured_bubble_two_point, profile_trace,
                     stage_busy_from_trace, stage_scope,
                     stage_timeline_from_trace)
from .telemetry import (Counter, EwmaTimer, Gauge, Histogram, MetricsRegistry,
                        StepReport, device_memory_peaks, get_registry,
                        null_registry, peak_flops_per_chip, set_registry,
                        train_flops_per_token)
from .tb_writer import ScalarWriter

__all__ = [
    "BubbleMeter", "device_memory_report", "measured_bubble_slope",
    "measured_bubble_two_point", "profile_trace", "stage_busy_from_trace",
    "stage_scope", "stage_timeline_from_trace",
    "EventLog", "NullEventLog", "NULL_EVENT_LOG", "SPAN_KINDS",
    "Counter", "EwmaTimer", "Gauge", "Histogram", "MetricsRegistry",
    "StepReport", "device_memory_peaks", "get_registry", "null_registry",
    "peak_flops_per_chip", "set_registry", "train_flops_per_token",
    "ScalarWriter",
]
