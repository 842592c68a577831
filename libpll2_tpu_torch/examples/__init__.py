"""The runnable demos of libpll2_tpu's examples/ on this package: one
module per JAX demo, with the same file name, positional arguments and
printed lines (README.md has the table).  Each runs as

    python -m libpll2_tpu_torch.examples.<name> [args] [--device cpu]

on the card by default, and raises where there is none; `--device cpu`
runs it on the host CPU at f64, the JAX examples' parity path.  Every
module keeps a main(argv=None), so that a caller can run it in-process.
"""
