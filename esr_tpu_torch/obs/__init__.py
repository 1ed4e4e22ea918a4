"""Host-side telemetry of the port (counterpart of ``esr_tpu/obs``, the
parts the serving fleet stands on).

Producing:

- :mod:`~esr_tpu_torch.obs.sink`: the JSONL telemetry sink and the
  process-active sink every instrumented component reads on each call;
- :mod:`~esr_tpu_torch.obs.trace`: ambient trace context (span identity and
  parentage through a ``contextvars`` context).

Consuming, live:

- :mod:`~esr_tpu_torch.obs.aggregate`: :class:`LiveAggregator` (streaming
  rollups and mergeable quantile sketches over the sink's records) and the
  ``/snapshot`` wire format;
- :mod:`~esr_tpu_torch.obs.http`: ``/metrics``, ``/healthz``, ``/slo`` and
  ``/snapshot`` over one aggregator;
- :mod:`~esr_tpu_torch.obs.fleetview`: :class:`FleetAggregator`, N
  replicas' snapshots merged, with staleness and the scaling signal.

Consuming, offline: :mod:`~esr_tpu_torch.obs.report` (``python -m
esr_tpu_torch.obs report <files> [--slo configs/slo.yml]``).

The files and wire documents are the reference's record for record, so
either package's reporter and fleet view read the other's. Not ported yet:
the profiler capture and device watermarks (``obs/device.py``), the Chrome
trace export, step attribution (``obs/spans.py``) and the numerics probe
plane.
"""

from esr_tpu_torch.obs import trace
from esr_tpu_torch.obs.aggregate import LiveAggregator, QuantileSketch, parse_snapshot_wire
from esr_tpu_torch.obs.fleetview import FleetAggregator, ScalingPolicy, start_fleet_plane
from esr_tpu_torch.obs.sink import (
    SCHEMA_VERSION,
    TelemetrySink,
    active_sink,
    config_fingerprint,
    run_manifest,
    set_active_sink,
)

__all__ = [
    "SCHEMA_VERSION",
    "FleetAggregator",
    "LiveAggregator",
    "QuantileSketch",
    "ScalingPolicy",
    "TelemetrySink",
    "active_sink",
    "config_fingerprint",
    "parse_snapshot_wire",
    "run_manifest",
    "set_active_sink",
    "start_fleet_plane",
    "trace",
]
