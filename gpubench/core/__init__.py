"""Part of the benchmark; see ``gpubench/README.md``."""
