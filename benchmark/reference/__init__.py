"""The plain reference the benchmark holds the program to: plain PyTorch
and numpy, importing nothing of the program."""
