"""Observability of the port: the latency statistics the simulator reports
from (``obs.stats``).  The registry, its exporters and the device counters
wait for ROADMAP A8."""
