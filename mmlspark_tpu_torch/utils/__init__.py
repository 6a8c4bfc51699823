"""Utilities: the profiler hooks (the serving engine's phase annotation,
``Timer``'s trace) and the shared tokenizer and feature hash."""
