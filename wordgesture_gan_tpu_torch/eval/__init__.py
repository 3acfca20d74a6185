"""Evaluation of the generator and the minimum-jerk baseline."""

from .gan_eval import evaluate_gan_and_minjerk, print_comparison_table, print_results_table
