"""KL divergences, prediction metrics and chained timing."""
from . import metrics, stats, timing

__all__ = ["metrics", "stats", "timing"]
