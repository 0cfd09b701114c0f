"""a2s.peak_gib: the largest max_memory_allocated of one streamed A²
pass, in GiB, read as ``a2.peak_gib`` reads it: the class buffers, the
stream and a slab's C, which streaming keeps under the card's memory."""

from gpubench.core.manifest import reader

read = reader("a2.peak_gib")
