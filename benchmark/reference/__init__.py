"""The plain reference the benchmark holds the port to: NumPy and SciPy (and
plain PyTorch for the large solves), importing nothing of the program."""
