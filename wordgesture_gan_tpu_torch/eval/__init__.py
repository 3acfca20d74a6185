"""Evaluation of the generator and the minimum-jerk baseline."""
