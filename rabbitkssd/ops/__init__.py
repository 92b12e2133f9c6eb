"""Device-side (JAX/XLA) compute kernels."""
