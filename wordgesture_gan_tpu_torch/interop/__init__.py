"""Weight interchange with the JAX package (numpy files only)."""
