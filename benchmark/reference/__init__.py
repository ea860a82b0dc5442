"""The plain reference: PyTorch and numpy only, no code of the program."""
