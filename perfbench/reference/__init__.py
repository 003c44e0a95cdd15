"""Plain PyTorch and NumPy references: no kernel, chain or helper of the program."""
