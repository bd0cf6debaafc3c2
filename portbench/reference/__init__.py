"""The plain float32 reference the benchmark holds the port's outputs against.

Plain PyTorch, TF32 off; it imports nothing of the port or of JAX."""
