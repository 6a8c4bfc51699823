"""Core: the error hierarchy, the CUDA device probe, the allocation-failure
classifier and the trimmed telemetry (metric registry, flight recorder)."""
