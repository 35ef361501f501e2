"""Evaluation: numpy metrics and the reference-format reports."""
