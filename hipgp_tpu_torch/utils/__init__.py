"""Block index tables, KL divergences, prediction metrics and frames,
state checkpoints and chained timing."""
from . import blocks, checkpoint, metrics, stats, timing

__all__ = ["blocks", "checkpoint", "metrics", "stats", "timing"]
