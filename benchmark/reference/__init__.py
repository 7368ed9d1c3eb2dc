"""The plain PyTorch reference that the benchmark's output checks compare with."""
