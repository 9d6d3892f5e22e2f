"""Dense SVGP baseline: the exact inducing-point posterior, O(M^3).

Counterpart of `hipgp_tpu/models/svgp.py`, the dense twin that HIP-GP is
held against: whitened (the L^{-1} basis, prior N(0, I)) and unwhitened
(the (Kmm + jitter I)^{-1} basis, prior N(0, Kmm)).  Its linear algebra is
dense and outside any kernel of the JAX package (Cholesky, triangular
solves, SPD inverses, products), so here it is ``torch.linalg`` and
``torch.matmul`` with TF32 off (`ops.bttb.fp32_matmul`).  As in the JAX
class, the natural gradient is returned unscaled: the reference's hard-coded
1000/N rescale is not applied (a fit that wants it scales its lr, as
`experiments/natgrad_trajectory.py` does).  The model is a plain container
(kernel, inducing points, sizes, dtype, device); the learnable state is the
:class:`SVGPState` dataclass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..kernels.interdomain import DoublyDiagInterpolator, k_semi_mc, k_semi_sqexp
from ..ops import spd_inverse, spd_solve
from ..ops.bttb import fp32_matmul
from ..ops.solve import cholesky_or_nan
from ..utils import stats

__all__ = ["SVGP", "SVGPState"]

LN2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass(frozen=True)
class SVGPState:
    """Learnable state: the natural parameters theta1 (M,), theta2 (M, M)
    and the two log-hyperparameters (0-dim tensors)."""

    theta1: torch.Tensor
    theta2: torch.Tensor
    log_sig2: torch.Tensor
    log_ell: torch.Tensor

    def replace(self, **changes) -> "SVGPState":
        return dataclasses.replace(self, **changes)


class SVGP:
    """Dense SVGP over the inducing points ``xinduce`` (M, D), with the JAX
    constructor's arguments; runs on ``device`` (CUDA unless the caller asks
    for the CPU) in ``dtype`` (default: that of ``xinduce`` when it is a
    floating tensor, else float32)."""

    def __init__(self, kernel, xinduce, num_obs: int, whitened: bool = False,
                 sig2_init: float = 1.0, ell_init: float = 1.0,
                 init_Svar: float = 0.1,
                 prior_ell: Tuple[float, float] = (0.1, 0.025),
                 prior_sig2: Tuple[float, float] = (1.0, 10.0),
                 jitter: float = 1e-3, support_integrated_obs: bool = False,
                 dtype: Optional[torch.dtype] = None, device="cuda"):
        xi = torch.as_tensor(xinduce)
        if dtype is None:
            dtype = xi.dtype if xi.is_floating_point() else torch.float32
        self.kernel = kernel
        self.dtype = dtype
        self.device = torch.device(device)
        self.xinduce = xi.to(dtype=dtype, device=self.device)
        self.M = self.xinduce.shape[0]
        self.N = int(num_obs)
        self.whitened = whitened
        self.jitter = float(jitter)
        self.init_Svar = float(init_Svar)
        self.sig2_init = float(sig2_init)
        self.ell_init = ell_init
        self.prior_ell = prior_ell
        self.prior_sig2 = prior_sig2
        self.diag_interp = (DoublyDiagInterpolator(kernel)
                            if support_integrated_obs else None)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _eye(self) -> torch.Tensor:
        return torch.eye(self.M, dtype=self.dtype, device=self.device)

    def init_state(self) -> SVGPState:
        return SVGPState(
            theta1=torch.zeros(self.M, dtype=self.dtype, device=self.device),
            theta2=(-0.5 / self.init_Svar) * self._eye(),
            log_sig2=self._t(math.log(self.sig2_init)),
            log_ell=torch.log(self._t(self.ell_init)),
        )

    def kernel_params(self, state: SVGPState):
        return torch.exp(state.log_sig2), torch.exp(state.log_ell)

    def standard_params(self, state: SVGPState):
        """(m, S) with S = (-2 theta2)^{-1} by Cholesky and m = S theta1."""
        S = spd_inverse(-2.0 * state.theta2)
        with fp32_matmul():
            return S @ state.theta1, S

    # ------------------------------------------------------------------

    def _kmm(self, state: SVGPState) -> torch.Tensor:
        return self.kernel(self.xinduce, self.xinduce, self.kernel_params(state))

    def make_grams(self, state: SVGPState, x: torch.Tensor,
                   integrated_obs: bool = False,
                   semi_integrated_estimator: str = "analytic",
                   semi_integrated_samps: int = 10,
                   generator: Optional[torch.Generator] = None,
                   u: Optional[float] = None):
        """(Knm (bsz, M), Knn_diag (bsz,)); with ``integrated_obs`` the
        semi-integrated cross-covariance ('analytic', or 'mc-biased' with
        its offset drawn from ``generator`` unless ``u`` gives it) and the
        doubly-integrated diagonal."""
        p = self.kernel_params(state)
        if not integrated_obs:
            return self.kernel(x, self.xinduce, p), self.kernel.diag(x, p)
        if semi_integrated_estimator == "analytic":
            Knm = k_semi_sqexp(self.xinduce, x, p).T
        elif semi_integrated_estimator == "mc-biased":
            Knm = k_semi_mc(self.kernel, self.xinduce, x, p,
                            npts=semi_integrated_samps, generator=generator, u=u).T
        else:
            raise ValueError(semi_integrated_estimator)
        if self.diag_interp is None:
            raise ValueError(
                "integrated_obs requires support_integrated_obs=True at build")
        return Knm, self.diag_interp(x, p)

    def make_kn(self, state: SVGPState, Knm: torch.Tensor,
                Kmm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """whitened: kn = (L^{-1} Kmn)^T; unwhitened: ((Kmm + jI)^{-1} Kmn)^T."""
        if Kmm is None:
            Kmm = self._kmm(state)
        A = Kmm + self.jitter * self._eye()
        if self.whitened:
            L = cholesky_or_nan(A)
            return torch.linalg.solve_triangular(L, Knm.T, upper=False).T
        return spd_solve(A, Knm.T).T

    def _ktilde_diag(self, Knn_diag, kn, Knm):
        if self.whitened:
            return Knn_diag - torch.sum(kn * kn, dim=-1)
        return Knn_diag - torch.sum(kn * Knm, dim=-1)

    def _kl(self, state, qm, qS, Kmm):
        if self.whitened:
            return stats.kl_to_standard(qm, qS)
        return stats.kl_mvn(qm, qS, torch.zeros_like(qm), Kmm + self.jitter * self._eye())

    def _prior_prec(self, Kmm):
        if self.whitened:
            return self._eye()
        return spd_inverse(Kmm + self.jitter * self._eye())

    # ------------------------------------------------------------------

    def batch_an(self, y, noise_std, kn, Knm, Knn_diag, qm, qS) -> torch.Tensor:
        """Per-point expected log-likelihood
        -1/(2 s^2) [(kn.m - y)^2 + ktilde + kn S kn] - log s - 1/2 log 2 pi."""
        y = y.reshape(-1)
        ns = noise_std.reshape(-1)
        ivar = 1.0 / (ns * ns)
        with fp32_matmul():
            knt_m = kn @ qm
            knSkn = torch.sum((kn @ qS) * kn, dim=-1)
        mse = (knt_m - y) ** 2
        variance = self._ktilde_diag(Knn_diag.reshape(-1), kn, Knm) + knSkn
        return -0.5 * ivar * (mse + variance) - torch.log(ns) - 0.5 * LN2PI

    @staticmethod
    def _mean_an(an, weights):
        if weights is None:
            return torch.mean(an)
        return torch.sum(an * weights) / torch.clamp(torch.sum(weights), min=1.0)

    def _elbo_parts(self, state, x, y, noise_std, flags, weights):
        Knm, Knn_diag = self.make_grams(state, x, **flags)
        Kmm = self._kmm(state)
        kn = self.make_kn(state, Knm, Kmm)
        qm, qS = self.standard_params(state)
        an = self.batch_an(y, noise_std, kn, Knm, Knn_diag, qm, qS)
        return self._mean_an(an, weights) - self._kl(state, qm, qS, Kmm) / self.N, kn, Kmm

    def elbo(self, state: SVGPState, x, y, noise_std, integrated_obs: bool = False,
             semi_integrated_estimator: str = "analytic",
             semi_integrated_samps: int = 10,
             generator: Optional[torch.Generator] = None, u: Optional[float] = None,
             weights: Optional[torch.Tensor] = None, **_) -> torch.Tensor:
        """Minibatch ELBO: mean(a_n) (weighted by the 0/1 ``weights``) - KL/N."""
        flags = dict(integrated_obs=integrated_obs,
                     semi_integrated_estimator=semi_integrated_estimator,
                     semi_integrated_samps=semi_integrated_samps,
                     generator=generator, u=u)
        with fp32_matmul():
            return self._elbo_parts(state, self._t(x), self._t(y), self._t(noise_std),
                                    flags, weights)[0]

    def elbo_and_grads(self, state: SVGPState, x, y, noise_std,
                       integrated_obs: bool = False,
                       semi_integrated_estimator: str = "analytic",
                       semi_integrated_samps: int = 10,
                       generator: Optional[torch.Generator] = None,
                       u: Optional[float] = None,
                       compute_kernel_grads: bool = False,
                       compute_hyper_grads: Optional[bool] = None,
                       weights: Optional[torch.Tensor] = None, group=None, **_):
        """(elbo, grads), ``grads`` an :class:`SVGPState` in descent
        convention: -deta for theta (the natural gradient, unscaled) and, with
        ``compute_kernel_grads`` (alias ``compute_hyper_grads``), -d/d
        log_sig2 and log_ell of the ELBO plus kernel_param_prior / N (theta
        held constant; the returned ELBO then includes that prior term), else
        zeros.  The signature takes HIPGP's (maxiter_cg and the like are
        accepted and ignored), so the shared fit loop drives either model.

        ``group``: a process group over whose ranks the batch's rows are
        split, as in `HIPGP.elbo_and_grads` (:meth:`_split_elbo_and_grads`)."""
        if compute_hyper_grads is not None:
            compute_kernel_grads = compute_hyper_grads
        if noise_std is None:
            raise ValueError(
                "SVGP has no learnable noise parameter (matching the "
                "reference, ziggy/svgp.py): per-point noise_std is required; "
                "learn_noise is a HIPGP-only feature")
        x, y, ns = self._t(x), self._t(y).reshape(-1), self._t(noise_std).reshape(-1)
        flags = dict(integrated_obs=integrated_obs,
                     semi_integrated_estimator=semi_integrated_estimator,
                     semi_integrated_samps=semi_integrated_samps,
                     generator=generator, u=u)
        if group is not None:
            return self._split_elbo_and_grads(state, x, y, ns, flags, weights,
                                              compute_kernel_grads, group)
        if weights is not None:
            bscale = self.N / torch.clamp(torch.sum(weights), min=1.0)
        else:
            bscale = self.N / y.shape[0]
        with fp32_matmul():
            if compute_kernel_grads:
                hypers = tuple(h.detach().requires_grad_()
                               for h in (state.log_sig2, state.log_ell))
                with torch.enable_grad():
                    st = state.replace(theta1=state.theta1.detach(),
                                       theta2=state.theta2.detach(),
                                       log_sig2=hypers[0], log_ell=hypers[1])
                    e, kn, Kmm = self._elbo_parts(st, x, y, ns, flags, weights)
                    elbo = e + self.kernel_param_prior(st) / self.N
                g = torch.autograd.grad(elbo, hypers)
                g_sig2, g_ell = -g[0], -g[1]
                elbo, kn, Kmm = elbo.detach(), kn.detach(), Kmm.detach()
            else:
                with torch.no_grad():
                    elbo, kn, Kmm = self._elbo_parts(state, x, y, ns, flags, weights)
                g_sig2 = torch.zeros_like(state.log_sig2)
                g_ell = torch.zeros_like(state.log_ell)
            with torch.no_grad():
                kn_t = kn / ns[:, None]
                if weights is not None:
                    kn_t = kn_t * torch.sqrt(weights)[:, None]
                Lam = bscale * (kn_t.T @ kn_t) + self._prior_prec(Kmm)
                dS = -0.5 * Lam - state.theta2
                yw = (y / ns) if weights is None else (y / ns) * torch.sqrt(weights)
                dm = bscale * (kn_t.T @ yw) - state.theta1
        return elbo, SVGPState(theta1=-dm, theta2=-dS, log_sig2=g_sig2, log_ell=g_ell)

    def _split_elbo_and_grads(self, state, x, y, ns, flags, weights, kernel_grads, group):
        """:meth:`elbo_and_grads` of a batch whose rows are split over the
        ranks of ``group``: sum w first, then in one all-reduce sum a_n w, the
        data part's hyper-gradients and the natural gradient's two data sums
        (kn^T kn and kn^T y, noise-scaled); KL, the kernel prior and the
        prior precision are counted once.  Every rank returns the same
        (elbo, grads)."""
        from ..parallel.mesh import all_reduce

        if weights is None:
            weights = torch.ones_like(y)
        (wsum,) = all_reduce([torch.sum(weights)], group)
        wsum = torch.clamp(wsum, min=1.0)
        hypers = (state.log_sig2, state.log_ell)
        zeros = tuple(torch.zeros_like(h) for h in hypers)
        with fp32_matmul():
            with torch.set_grad_enabled(kernel_grads):
                if kernel_grads:
                    hypers = tuple(h.detach().requires_grad_() for h in hypers)
                st = state.replace(theta1=state.theta1.detach(),
                                   theta2=state.theta2.detach(),
                                   log_sig2=hypers[0], log_ell=hypers[1])
                Knm, Knn_diag = self.make_grams(st, x, **flags)
                Kmm = self._kmm(st)
                kn = self.make_kn(st, Knm, Kmm)
                qm, qS = self.standard_params(st)
                an_sum = torch.sum(self.batch_an(y, ns, kn, Knm, Knn_diag, qm, qS)
                                   * weights)
                once = -self._kl(st, qm, qS, Kmm) / self.N
                if kernel_grads:
                    once = once + self.kernel_param_prior(st) / self.N
            g_data = g_once = zeros
            if kernel_grads:
                fill = lambda gs: tuple(z if g is None else g for g, z in zip(gs, zeros))
                g_data = fill(torch.autograd.grad(an_sum / wsum, hypers,
                                                  retain_graph=True, allow_unused=True))
                g_once = fill(torch.autograd.grad(once, hypers, allow_unused=True))
            with torch.no_grad():
                kn_t = kn.detach() / ns[:, None] * torch.sqrt(weights)[:, None]
                yw = (y / ns) * torch.sqrt(weights)
                an_sum, g_sig2, g_ell, gram, kty = all_reduce(
                    [an_sum.detach(), *g_data, kn_t.T @ kn_t, kn_t.T @ yw], group)
                bscale = self.N / wsum
                dS = -0.5 * (bscale * gram + self._prior_prec(Kmm.detach())) - state.theta2
                dm = bscale * kty - state.theta1
                elbo = an_sum / wsum + once.detach()
        return elbo, SVGPState(theta1=-dm, theta2=-dS, log_sig2=-(g_sig2 + g_once[0]),
                               log_ell=-(g_ell + g_once[1]))

    def batch_solve(self, state: SVGPState, xobs, yobs, noise_std, batch_size: int = -1,
                    integrated_obs: bool = False,
                    semi_integrated_estimator: str = "analytic",
                    semi_integrated_samps: int = 10,
                    generator: Optional[torch.Generator] = None,
                    u: Optional[float] = None, compute_elbo: bool = False, **_):
        """The closed-form optimal q over all rows at once (``batch_size``
        and HIPGP's solver options are accepted and ignored, as in the JAX
        class); with ``compute_elbo`` (state, elbo)."""
        x, y = self._t(xobs), self._t(yobs).reshape(-1)
        ns = self._t(noise_std).reshape(-1)
        N = x.shape[0]
        with fp32_matmul():
            Kmm = self._kmm(state)
            Knm, Knn_diag = self.make_grams(
                state, x, integrated_obs, semi_integrated_estimator,
                semi_integrated_samps, generator, u)
            kn = self.make_kn(state, Knm, Kmm)
            kn_t = kn / ns[:, None]
            Lam = self._prior_prec(Kmm)
            Lam += kn_t.T @ kn_t
            b = kn_t.T @ (y / ns)
            del kn_t
            new_state = state.replace(theta1=b, theta2=-0.5 * Lam)
            del Lam
            if not compute_elbo:
                return new_state
            qm, qS = self.standard_params(new_state)
            an = self.batch_an(y, ns, kn, Knm, Knn_diag, qm, qS)
            elbo = torch.sum(an) / N - self._kl(new_state, qm, qS, Kmm) / self.N
        return new_state, elbo

    def predict(self, state: SVGPState, x, integrated_obs: bool = False,
                semi_integrated_estimator: str = "analytic",
                semi_integrated_samps: int = 10,
                generator: Optional[torch.Generator] = None,
                u: Optional[float] = None, var_clamp: float = 0.0, **_):
        """(mu, sig) of the latent (or integrated) field at x; the Nystrom
        residual floored at ``var_clamp``."""
        x = self._t(x)
        with fp32_matmul():
            Knm, Knn_diag = self.make_grams(
                state, x, integrated_obs, semi_integrated_estimator,
                semi_integrated_samps, generator, u)
            Kmm = self._kmm(state)
            kn = self.make_kn(state, Knm, Kmm)
            qm, qS = self.standard_params(state)
            mu = kn @ qm
            ktilde = torch.clamp(self._ktilde_diag(Knn_diag.reshape(-1), kn, Knm),
                                 min=var_clamp)
            sig = torch.sqrt(ktilde + torch.sum((kn @ qS) * kn, dim=-1))
        return mu, sig

    def kernel_param_prior(self, state: SVGPState) -> torch.Tensor:
        """Gamma log-prior on the lengthscale (`ziggy/svgp.py:361-375`)."""
        mu, sig = self.prior_ell
        alpha, beta = stats.gamma_params(mu, sig ** 2)
        return stats.gamma_lnpdf_lnx(state.log_ell, alpha, beta)
