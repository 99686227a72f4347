"""Evaluation helpers: the golden-file comparator."""
