"""Natural-gradient SVI, the lengthscale search by the closed-form solve,
and chunked prediction."""
from .fit import (FitConfig, batch_predict, ell_fit, make_optimizer, make_train_step,
                  predictive_variance_correction, prepare_batches, svigp_fit)

__all__ = ["FitConfig", "svigp_fit", "ell_fit", "batch_predict",
           "predictive_variance_correction", "make_optimizer", "make_train_step",
           "prepare_batches"]
