"""KL divergences and prediction metrics."""
from . import metrics, stats

__all__ = ["metrics", "stats"]
