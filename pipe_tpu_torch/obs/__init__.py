"""Observability: metrics registry and step reports (``telemetry``), the
JSONL event log (``events``), profiler ranges and traces, bubble measurement
and per-stage timelines (``meters``), TensorBoard scalars (``tb_writer``) and
the fleet observability plane (``fleet_obs``: merged replica metrics,
stitched request traces, SLO verdicts, Prometheus text). Counterpart of
``pipe_tpu/obs`` without the xplane reader (torch writes Chrome traces,
which ``meters`` reads)."""

from .events import EventLog, NULL_EVENT_LOG, NullEventLog, SPAN_KINDS
from .fleet_obs import (STAGE_RANK, FleetObserver, SloMonitor, SloTargets,
                        TraceBuffer, prometheus_text)
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
    "FleetObserver", "SloMonitor", "SloTargets", "TraceBuffer",
    "prometheus_text", "STAGE_RANK",
    "Counter", "EwmaTimer", "Gauge", "Histogram", "MetricsRegistry",
    "StepReport", "device_memory_peaks", "get_registry", "null_registry",
    "peak_flops_per_chip", "set_registry", "train_flops_per_token",
    "ScalarWriter",
]
