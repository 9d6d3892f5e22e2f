"""Experiments: the paper's synthetic 2-D protocol and the 1-D whitening-solve timing (section 5.2)."""
