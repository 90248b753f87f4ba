"""Plain PyTorch references of the benchmark's configurations, one module a
configuration (named by its ``reference`` key), and plain RDP accounting.
Nothing here imports the program or JAX."""
