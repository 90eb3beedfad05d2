"""repro_torch.obs: metrics, tracing and on-device counters (twin of
``repro/obs``).

* ``registry()``: the process-global ``Registry`` of counters, gauges,
  streaming histograms and nested spans.  Disabled by default (a true
  no-op); enable with ``obs.enable()`` or ``REPRO_OBS=1``.
* ``device``: the link taps that turn the link's mask draws into the
  ``DeviceCounters`` dict the slot-pool engines carry on the device (read
  on the host only at sync points).
* ``exporters``: JSONL event log, Prometheus text, a chrome://tracing
  trace, and the ``torch.profiler`` wrapper behind ``--profile-dir``.
* ``stats``: exact percentiles and the streaming histogram.
"""

from repro_torch.obs import device, exporters, stats
from repro_torch.obs.log import get_logger
from repro_torch.obs.registry import Registry, disable, enable, registry

# The DeviceCounters constructor (the engines carry it as state).
DeviceCounters = device.counter_zeros

__all__ = [
    "Registry",
    "registry",
    "enable",
    "disable",
    "get_logger",
    "stats",
    "device",
    "exporters",
    "DeviceCounters",
]
