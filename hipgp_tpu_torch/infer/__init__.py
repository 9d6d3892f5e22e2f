"""Natural-gradient SVI and chunked prediction."""
from .fit import FitConfig, batch_predict, make_optimizer, prepare_batches, svigp_fit

__all__ = ["FitConfig", "svigp_fit", "batch_predict", "make_optimizer",
           "prepare_batches"]
