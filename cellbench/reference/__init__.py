"""Plain references: float64 PyTorch, importing nothing of the program."""
