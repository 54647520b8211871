"""Host-side NumPy metrics (copies of the JAX package's jax-free `metrics/`)."""
