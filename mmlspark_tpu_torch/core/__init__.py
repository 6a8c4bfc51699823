"""Core: the error hierarchy and the CUDA device probe."""
