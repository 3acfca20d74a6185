"""Generator model and its layers."""
