"""Dataset views the trainer takes (the port of parts of the JAX package's ``data/``)."""
