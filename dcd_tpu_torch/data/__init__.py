"""Host-side data helpers copied from the JAX package."""
