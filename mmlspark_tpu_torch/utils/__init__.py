"""Utilities: the profiler annotation the serving engine's phases run
under."""
