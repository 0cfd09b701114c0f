"""The benchmark of ``combblas_tpu_torch`` on an NVIDIA GPU.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``README.md`` says how
the harness finds configurations, traffic mixes, drivers and metric readers
by name.  Nothing here imports JAX or the JAX package.
"""
