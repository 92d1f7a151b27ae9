"""Plain references that hold the port against its specification:
plain PyTorch and NumPy, importing nothing else of the package."""
