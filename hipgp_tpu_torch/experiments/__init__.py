"""Experiments: the paper's synthetic 2-D protocol."""
