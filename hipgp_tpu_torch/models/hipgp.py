"""HIP-GP: hierarchical inducing-point GP with a BTTB-structured prior.

Counterpart of `hipgp_tpu/models/hipgp.py`, for the mean-field family with
circulant ('ziggy') whitening and the expectation-family parameters.  The
model object is a plain container (kernel, grids, sizes, dtype, device); all
learnable state lives in the
:class:`HIPGPState` dataclass, and every method is a function of
(state, data).  ``elbo_and_grads`` returns the natural gradient as a state-
shaped dataclass and, with ``compute_hyper_grads``, the gradient of the ELBO
in the three log-hyperparameters, taken by autograd through the kernel, the
spectrum and the whitening solve (`ops/solve.py`, implicit differentiation).
Observations are points, or line integrals of the field (``integrated_obs``:
the ray from the origin to each x, paper section 5.5) with the
semi-integrated cross-covariances of `kernels/interdomain.py`.  The block and
full-rank families, the cholesky whitening and the closed-form batch solve
are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.interdomain import DoublyDiagInterpolator, k_semi_mc, k_semi_sqexp
from ..ops import make_spectrum, whiten
from ..ops.bttb import BTTBSpectrum, embedded_dims
from ..utils import stats

__all__ = ["HIPGP", "HIPGPState"]

LN2PI = math.log(2.0 * math.pi)
# floor of the latent predictive variance Knn - kn.kn (the JAX default)
VAR_CLAMP = 1e-5


@dataclasses.dataclass(frozen=True)
class HIPGPState:
    """Learnable state.  ``theta1``/``theta2`` (M',) are the natural
    (expectation-family) parameters of q in the whitened space; the three
    log-hyperparameters are 0-dim tensors."""

    theta1: torch.Tensor
    theta2: torch.Tensor
    log_sig2: torch.Tensor
    log_ell: torch.Tensor
    log_noise2: torch.Tensor

    def replace(self, **changes) -> "HIPGPState":
        return dataclasses.replace(self, **changes)


class HIPGP:
    """Mean-field HIP-GP with circulant whitening and expectation-family
    natural parameters (the JAX package's defaults) over the inducing grid
    ``xgrids`` (1-D tensors or arrays).  The other arguments are the JAX
    constructor's; ``support_integrated_obs`` builds the doubly-integrated
    diagonal's table, which line-integral observations need, and
    ``learn_kernel``/``learn_noise`` are stored as the JAX model stores them
    (the fit's `FitConfig` decides what is learned).  Runs on ``device``
    (CUDA unless the caller asks for the CPU) in ``dtype``."""

    def __init__(
        self,
        kernel,
        xgrids: Sequence,
        num_obs: int,
        jitter: float = 1e-3,
        sig2_init: float = 1.0,
        ell_init: float = 0.05,
        noise2_init: float = 1.0,
        init_Svar: float = 0.1,
        learn_kernel: bool = False,
        learn_noise: bool = False,
        support_integrated_obs: bool = False,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        self.kernel = kernel
        self.jitter = float(jitter)
        self.N = int(num_obs)
        self.learn_kernel = learn_kernel
        self.learn_noise = learn_noise
        self.dtype = dtype
        self.device = torch.device(device)
        self.sig2_init = float(sig2_init)
        self.ell_init = ell_init
        self.noise2_init = float(noise2_init)
        self.init_Svar = float(init_Svar)

        self.xgrids = tuple(torch.as_tensor(g).to(dtype=dtype, device=self.device)
                            for g in xgrids)
        self.dims = tuple(len(g) for g in self.xgrids)
        mesh = torch.meshgrid(*self.xgrids, indexing="ij")
        self.xinduce = torch.stack([m.reshape(-1) for m in mesh], dim=-1)  # (M, D)
        self.M = math.prod(self.dims)
        self.ndim = len(self.dims)
        self.edims = embedded_dims(self.dims)
        self.Mprime = math.prod(self.edims)
        self.diag_interp = (DoublyDiagInterpolator(kernel)
                            if support_integrated_obs else None)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> HIPGPState:
        """Glorot-style theta1 drawn from ``generator`` (a CPU generator;
        seed 0 when None), theta2 = -1/(2 init_Svar)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        Mp = self.Mprime
        std = math.sqrt(2.0 / (Mp + 1))
        theta1 = std * torch.randn(Mp, generator=generator, dtype=self.dtype)
        theta2 = torch.full((Mp,), -0.5 / self.init_Svar, dtype=self.dtype)
        return HIPGPState(
            theta1=theta1.to(self.device),
            theta2=theta2.to(self.device),
            log_sig2=self._scalar(math.log(self.sig2_init)),
            log_ell=torch.log(self._scalar(self.ell_init)),
            log_noise2=self._scalar(math.log(self.noise2_init)),
        )

    def kernel_params(self, state: HIPGPState):
        return torch.exp(state.log_sig2), torch.exp(state.log_ell)

    # ------------------------------------------------------------------
    # covariance plumbing
    # ------------------------------------------------------------------

    def spectrum(self, state: HIPGPState) -> BTTBSpectrum:
        p = self.kernel_params(state)
        return make_spectrum(self.xgrids, lambda x, y: self.kernel(x, y, p),
                             jitter=self.jitter)

    def make_grams(self, state: HIPGPState, x: torch.Tensor,
                   integrated_obs: bool = False,
                   semi_integrated_estimator: str = "analytic",
                   semi_integrated_samps: int = 10,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Knm (bsz, M), Knn_diag (bsz,)).  With ``integrated_obs`` the rows
        of x are the ends of rays from the origin: Knm is the semi-integrated
        cross-covariance ('analytic' for SqExp, or 'mc-biased' with
        ``semi_integrated_samps`` points per ray drawn from ``generator``) and
        Knn_diag the doubly-integrated diagonal."""
        params = self.kernel_params(state)
        if not integrated_obs:
            return self.kernel(x, self.xinduce, params), self.kernel.diag(x, params)
        if semi_integrated_estimator == "analytic":
            if not getattr(self.kernel, "has_k_semi", False):
                raise ValueError(
                    "analytic semi-integrated estimator requires a kernel "
                    "with a closed form (SqExp); use 'mc-biased'")
            Knm = k_semi_sqexp(self.xinduce, x, params).T
        elif semi_integrated_estimator == "mc-biased":
            Knm = k_semi_mc(self.kernel, self.xinduce, x, params,
                            npts=semi_integrated_samps, generator=generator).T
        else:
            raise ValueError(
                f"unknown estimator {semi_integrated_estimator!r} "
                "(the quadrature oracle is host-only: kernels.k_semi_quad)")
        if self.diag_interp is None:
            raise ValueError(
                "integrated_obs requires support_integrated_obs=True at build")
        return Knm, self.diag_interp(x, params)

    def compute_kn(self, state: HIPGPState, Knm: torch.Tensor,
                   maxiter_cg: int = 10,
                   spec: Optional[BTTBSpectrum] = None) -> torch.Tensor:
        """kn = R^T K^{-1} Kmn, the whitened cross-covariances (bsz, M')."""
        if spec is None:
            spec = self.spectrum(state)
        return whiten(spec, Knm, maxiter=maxiter_cg)

    # ------------------------------------------------------------------
    # variational family
    # ------------------------------------------------------------------

    def standard_params(self, state: HIPGPState):
        """(qm (M',), qS (M',)) from the natural parameters."""
        S = -0.5 / state.theta2
        return S * state.theta1, S

    def compute_knSkn(self, kn: torch.Tensor, qS: torch.Tensor) -> torch.Tensor:
        """diag(kn S kn^T) per batch row."""
        return torch.sum(kn * qS[None, :] * kn, dim=-1)

    def kl_to_prior(self, qm: torch.Tensor, qS: torch.Tensor) -> torch.Tensor:
        return stats.diag_kl_to_standard(qm, qS)

    def get_lam(self, ivar: torch.Tensor, kn: torch.Tensor, bscale=1.0,
                add_identity: bool = True) -> torch.Tensor:
        """Lambda = bscale * sum_n kn_n^2 / sigma_n^2 (+ 1), diagonal."""
        lam = bscale * torch.sum(ivar[:, None] * kn * kn, dim=0)
        return lam + 1.0 if add_identity else lam

    # ------------------------------------------------------------------
    # ELBO pieces
    # ------------------------------------------------------------------

    def _ivar_and_lognoise(self, state, noise_std, bsz):
        """(ivar (bsz,), log_noise_std (bsz,) or scalar)."""
        if noise_std is not None:
            ns = noise_std.reshape(-1)
            return 1.0 / (ns * ns), torch.log(ns)
        ivar = torch.exp(-state.log_noise2) * torch.ones(
            (bsz,), dtype=self.dtype, device=self.device)
        return ivar, 0.5 * state.log_noise2

    def batch_an(self, state, y, noise_std, kn, Knn_diag, qm, qS) -> torch.Tensor:
        """Per-point expected log-likelihood
        a_n = -1/(2 s_n^2) [ (kn.m - y)^2 + Knn - kn.kn + kn S kn ]
              - log s_n - 1/2 log 2 pi."""
        y = y.reshape(-1)
        ivar, log_noise_std = self._ivar_and_lognoise(state, noise_std, y.shape[0])
        knt_m = kn @ qm
        knt_kn = torch.sum(kn * kn, dim=-1)
        knSkn = self.compute_knSkn(kn, qS)
        mse = (knt_m - y) ** 2
        variance = Knn_diag.reshape(-1) - knt_kn + knSkn
        return -0.5 * ivar * (mse + variance) - log_noise_std - 0.5 * LN2PI

    def _mean_an(self, an, weights):
        if weights is None:
            return torch.mean(an)
        return torch.sum(an * weights) / torch.clamp(torch.sum(weights), min=1.0)

    def elbo(self, state: HIPGPState, x: torch.Tensor, y: torch.Tensor,
             noise_std: Optional[torch.Tensor] = None, maxiter_cg: int = 10,
             integrated_obs: bool = False,
             semi_integrated_estimator: str = "analytic",
             semi_integrated_samps: int = 10,
             generator: Optional[torch.Generator] = None,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Minibatch ELBO estimate: mean(a_n) - KL/N.  ``weights`` (0/1 per
        row) masks padded rows; the observation flags are `make_grams`'."""
        Knm, Knn_diag = self.make_grams(state, x, integrated_obs,
                                        semi_integrated_estimator,
                                        semi_integrated_samps, generator)
        kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg)
        qm, qS = self.standard_params(state)
        an = self.batch_an(state, y, noise_std, kn, Knn_diag, qm, qS)
        return self._mean_an(an, weights) - self.kl_to_prior(qm, qS) / self.N

    # ------------------------------------------------------------------
    # natural gradient
    # ------------------------------------------------------------------

    def _natgrad(self, state, kn, y, ivar, qm, bscale):
        """(deta1, deta2): natural-gradient ascent directions."""
        y = y.reshape(-1)
        knt_m = kn @ qm
        bdiff = ivar * (knt_m - y)              # (bsz,)
        data_dm = -(kn.T @ bdiff)               # (M',)
        dm = bscale * data_dm - qm
        lam_diag = bscale * torch.sum(ivar[:, None] * kn * kn, dim=0) + 1.0
        dS = -0.5 * lam_diag - state.theta2
        deta1 = dm + dS * (-2.0 * qm)
        return deta1, dS

    def elbo_and_grads(self, state: HIPGPState, x: torch.Tensor,
                       y: torch.Tensor, noise_std: Optional[torch.Tensor] = None,
                       maxiter_cg: int = 10, integrated_obs: bool = False,
                       semi_integrated_estimator: str = "analytic",
                       semi_integrated_samps: int = 10,
                       generator: Optional[torch.Generator] = None,
                       weights: Optional[torch.Tensor] = None,
                       compute_hyper_grads: bool = False):
        """ELBO and natural gradients (and hyperparameter gradients).

        Returns (elbo, grads), ``grads`` a :class:`HIPGPState` in descent
        convention: the theta entries hold -deta, so that
        ``theta - lr * grad = theta + lr * deta``; with
        ``compute_hyper_grads`` the hyperparameter entries hold
        -d elbo / d log_sig2, log_ell, log_noise2 (theta1 and theta2 held
        constant), else zeros."""
        y = y.reshape(-1)
        hypers = (state.log_sig2, state.log_ell, state.log_noise2)
        with torch.set_grad_enabled(compute_hyper_grads):
            if compute_hyper_grads:
                hypers = tuple(h.detach().requires_grad_() for h in hypers)
            st = state.replace(theta1=state.theta1.detach(),
                               theta2=state.theta2.detach(), log_sig2=hypers[0],
                               log_ell=hypers[1], log_noise2=hypers[2])
            Knm, Knn_diag = self.make_grams(st, x, integrated_obs,
                                            semi_integrated_estimator,
                                            semi_integrated_samps, generator)
            kn = self.compute_kn(st, Knm, maxiter_cg=maxiter_cg)
            qm, qS = self.standard_params(st)
            an = self.batch_an(st, y, noise_std, kn, Knn_diag, qm, qS)
            elbo = self._mean_an(an, weights) - self.kl_to_prior(qm, qS) / self.N
        if compute_hyper_grads:
            hgrads = torch.autograd.grad(elbo, hypers, allow_unused=True)
            g_sig2, g_ell, g_noise2 = (torch.zeros_like(h) if g is None else -g
                                       for g, h in zip(hgrads, hypers))
            elbo, kn = elbo.detach(), kn.detach()
        else:
            g_sig2, g_ell, g_noise2 = (torch.zeros_like(h) for h in hypers)

        ivar, _ = self._ivar_and_lognoise(state, noise_std, y.shape[0])
        if weights is not None:
            ivar = ivar * weights
            bscale = self.N / torch.clamp(torch.sum(weights), min=1.0)
        else:
            bscale = self.N / y.shape[0]
        deta1, deta2 = self._natgrad(state, kn, y, ivar, qm, bscale)
        grads = HIPGPState(
            theta1=-deta1,
            theta2=-deta2,
            log_sig2=g_sig2,
            log_ell=g_ell,
            log_noise2=g_noise2,
        )
        return elbo, grads

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def predict(self, state: HIPGPState, x: torch.Tensor, maxiter_cg: int = 50,
                integrated_obs: bool = False,
                semi_integrated_estimator: str = "analytic",
                semi_integrated_samps: int = 10,
                generator: Optional[torch.Generator] = None):
        """(mu*, sig*): posterior mean and marginal std at x (of the line
        integrals with ``integrated_obs``); the latent variance is floored at
        VAR_CLAMP."""
        Knm, Knn_diag = self.make_grams(state, x, integrated_obs,
                                        semi_integrated_estimator,
                                        semi_integrated_samps, generator)
        kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg)
        qm, qS = self.standard_params(state)
        mu = kn @ qm
        ktilde = torch.clamp(Knn_diag.reshape(-1) - torch.sum(kn * kn, dim=-1),
                             min=VAR_CLAMP)
        sig = torch.sqrt(ktilde + self.compute_knSkn(kn, qS))
        return mu, sig
