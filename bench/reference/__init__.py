"""Plain PyTorch references of the benchmark's configurations: no kernel,
no cache, no batching, and nothing of the program."""
