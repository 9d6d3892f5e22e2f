"""KL divergences, prediction metrics and frames, state checkpoints and
chained timing."""
from . import checkpoint, metrics, stats, timing

__all__ = ["checkpoint", "metrics", "stats", "timing"]
