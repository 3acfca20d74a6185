"""Sampling loop and checkpoint reading."""
