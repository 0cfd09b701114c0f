"""Graph generators (port of ``combblas_tpu/gen``)."""
