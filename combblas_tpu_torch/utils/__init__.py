"""Timers and profiling helpers (port of ``combblas_tpu/utils``)."""
