"""Matrix and vector I/O (port of ``combblas_tpu/io``)."""
