"""Local sparse operations (port of ``combblas_tpu/ops``)."""
