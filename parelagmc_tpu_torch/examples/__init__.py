"""Command-line drivers of the port, twins of the JAX package's examples/.

Each runs as `python -m parelagmc_tpu_torch.examples.<name> [options]`
(options: `common.build_parser`, plus `--device`, default cuda:0), and its
`main(argv=None)` returns what the original returns and prints the same
lines in the same format.
"""
