"""Graph algorithms (port of ``combblas_tpu/models``)."""
