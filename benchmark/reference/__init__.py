"""Plain PyTorch references of what the benchmark's cells compute."""
