"""The plain reference the benchmark judges the program by: float64 PyTorch
and NumPy, importing nothing of the program."""
