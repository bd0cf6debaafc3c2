"""Parallelism of the port: logical-axis sharding over DTensor and gradient
compression."""
