"""The plain reference: NumPy and PyTorch, importing nothing of the program."""
