"""Evaluation metrics (``diff_foley_tpu/eval``): alignment accuracy."""
