"""Plain references of the benchmark's configurations: PyTorch and NumPy
alone, nothing of the program (a test scans every import)."""
