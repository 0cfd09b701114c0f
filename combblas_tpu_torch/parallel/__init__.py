"""Distributed layer on a block grid (port of ``combblas_tpu/parallel``)."""
