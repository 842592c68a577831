"""The benchmark of libpll2_tpu_torch: see README.md beside this file."""
