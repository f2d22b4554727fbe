"""Plain PyTorch references the benchmark judges the program by."""
