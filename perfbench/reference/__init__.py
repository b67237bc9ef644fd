"""The plain reference of the benchmark's check: plain PyTorch, nothing of the program."""
