"""Observability base (port of ``repro.obs``): trace records and their
exporters, the metrics registry, the telemetry hub the runtimes record
into, and the wall-clock and sim-time timers."""
