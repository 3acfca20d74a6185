"""The evaluation metric suite."""
