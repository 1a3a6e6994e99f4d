"""The benchmark of `autopanostitch_tpu_torch` (see README.md)."""
