"""portbench: the benchmark of timecrystal_tpu_torch (see README.md)."""
