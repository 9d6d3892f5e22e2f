"""HIP-GP: hierarchical inducing-point GP with a BTTB-structured prior.

Counterpart of `hipgp_tpu/models/hipgp.py`: the mean-field, block-diagonal
and full-rank variational families, with the expectation-family or the
standard parameterization, in both whitened spaces: 'ziggy' (the expanded
circulant basis, M' = prod(2 m_d - 2), kn = R^T K^{-1} Kmn by PCG) and
'cholesky' (the dense L^{-1} basis, M' = M).  The block family chunks the
whitened grid into blocks (`utils/blocks.py`), each with a dense covariance;
its per-block outer products, batched SPD inverses and the full-rank
family's dense Lambda and S are PyTorch matrix products in full FP32 (no
kernel of the JAX package's covers them).  The model object is a
plain container (kernel, grids, sizes, dtype, device); all learnable state
lives in the :class:`HIPGPState` dataclass, and every method is a function
of (state, data).  ``elbo_and_grads`` returns the natural gradient as a
state-shaped dataclass and, with ``compute_hyper_grads``, the gradient of the
ELBO in the three log-hyperparameters, taken by autograd through the kernel,
the spectrum and the whitening solve (`ops/solve.py`, implicit
differentiation).  ``batch_solve`` is the closed-form full-batch optimum of
the family, with the mean solved densely ('dense'), by CG over the stacked
kn ('cg'), through the original-space data Gram ('gram'), with Lambda and
the ELBO from that Gram's Cholesky factor as well ('factored', with its
exactness guards and the warned fallback to 'gram') or by CG whose data-Gram
matvec re-sweeps the data ('matfree': no M x M tensor, the solver of the
paper-scale 3-D grids).  Observations are points, or line integrals of the
field (``integrated_obs``: the ray from the origin to each x, paper section
5.5) with the semi-integrated cross-covariances of `kernels/interdomain.py`.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..infer.fit import prepare_batches
from ..kernels.interdomain import DoublyDiagInterpolator, k_semi_mc, k_semi_sqexp
from ..ops import (inv_matmul, make_spectrum, matmul_by_Cinv, matmul_by_K, matmul_by_R,
                   matmul_by_RT, pcg_result, spd_inverse, spd_solve, whiten)
from ..ops.bttb import BTTBSpectrum, embedded_dims, fp32_matmul
from ..utils import blocks as blk
from ..utils import stats

__all__ = ["HIPGP", "HIPGPState", "MEAN_PCG_STATS", "FACTORED_STATS",
           "FactoredSolveInconsistency"]

LN2PI = math.log(2.0 * math.pi)
# dtype of the 'gram' solver's M-space accumulators and mean solve: the data
# Gram A = sum ivar Knm Knm^T summed in float32 moves the mean
# z = (K + A)^{-1} b_m by more than 5e-3 relative on the 2-D protocol's
# data, whatever the mean solver's precision or iterations; summed in
# float64 from the same float32 Knm it does not
# (tests/test_torch_fullbatch.py::test_gram_accumulates_in_float64)
GRAM_ACC_DTYPE = torch.float64
# the last mean-stage PCG ('cg', and 'gram', 'factored' and 'matfree' under
# 'ziggy'): iterations run, final ||r||_2 and ||b||_2 ('matfree' stops on
# ||r||_2 <= mean_solver_tol ||b||_2, the others on ||r||_2 <= mean_solver_tol)
MEAN_PCG_STATS = {"iterations": 0, "resnorm": float("nan"), "bnorm": float("nan")}
# f32 trust region of the 'factored' solver's pre-check on the spectrum's
# dynamic range kappa = max(eigs) / min(eigs) (the JAX package's value);
# module-level so that an accuracy study can probe past it
FACTORED_F32_KAPPA_MAX = 1e3
# the 'factored' solver's two exactness guards; off only for accuracy studies
# that need the raw factored output past a firing guard
FACTORED_GUARDS = True
# the last 'factored' solve's checks: kappa (nan without a spectrum), the
# absolute jitter of A's factor, tr(K^{-1} A), sum ivar Knn and the variance
# bracket sum ivar Knn - tr(K^{-1} A) + sum(S * Lambda) (nan where not reached)
FACTORED_STATS = dict.fromkeys(("kappa", "jitter", "trKinvA", "sKnn", "bracket"),
                               float("nan"))
# rows of the factor whitened per solve in the 'factored' g-stage (ziggy)
FACTOR_CHUNK = 2048
# floor of the latent predictive variance Knn - kn.kn (the JAX default)
VAR_CLAMP = 1e-5
# device-memory cap of one block-ordered copy of kn, (rows, nb, bs), in the
# block family's Lambda: the rows are gathered this many bytes at a time
# (one copy at the dust map's batch of 512 rows, M' = 2^20, float32)
BLOCK_GATHER_BYTES = 2 << 30


@dataclasses.dataclass(frozen=True)
class HIPGPState:
    """Learnable state.  ``theta1``/``theta2`` are the natural
    (expectation-family) parameters of q in the whitened space, or (m, S)
    under the 'standard' parameterization: theta1 (M',); theta2 (M',)
    mean-field, (num_blocks, bs, bs) block, (M', M') full-rank.  The three
    log-hyperparameters are 0-dim tensors."""

    theta1: torch.Tensor
    theta2: torch.Tensor
    log_sig2: torch.Tensor
    log_ell: torch.Tensor
    log_noise2: torch.Tensor

    def replace(self, **changes) -> "HIPGPState":
        return dataclasses.replace(self, **changes)


class _StageClock:
    """Seconds between marks into ``timings`` (a dict, or None for no
    timing), the card synchronised at each mark."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings, self.cuda = timings, torch.device(device).type == "cuda"
        self.t = time.perf_counter() if timings is not None else None

    def mark(self, name: str):
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        self.timings[name] = t - self.t
        self.t = t


def _mean_pcg(matvec, b, precond, maxiter, tol):
    """PCG on one right-hand side b (n,), its iterations and residual
    recorded in MEAN_PCG_STATS."""
    res = pcg_result(matvec, b[None, :], precond=precond, maxiter=maxiter, tol=tol)
    MEAN_PCG_STATS.update(iterations=res.iters, resnorm=float(res.resnorm[0]),
                          bnorm=float(b.norm()))
    return res.x[0]


class FactoredSolveInconsistency(RuntimeError):
    """The 'factored' batch solve failed an exactness check.

    For any PSD kernel sum_n ivar_n kn_n.kn_n <= sum_n ivar_n Knn_n (the
    Nystrom residual is a Schur complement of a PSD matrix).  The factored
    solver computes the left side as tr(K^{-1} A) = ||W L_A||_F^2 through
    truncated PCG solves on the localized columns of the data Gram's Cholesky
    factor; on clamped spectra in float32 those solves can be far less
    converged than the smooth kernel-row solves of the sweep-based paths.
    `HIPGP.batch_solve` catches it, warns and falls back to 'gram'."""


def _cast_spec(spec: BTTBSpectrum, dtype: torch.dtype) -> BTTBSpectrum:
    cast = lambda t: None if t is None else t.to(dtype)
    return dataclasses.replace(spec, column=cast(spec.column), eigs=cast(spec.eigs),
                               ecolumn=cast(spec.ecolumn))


class HIPGP:
    """HIP-GP over the inducing grid ``xgrids`` (1-D tensors or arrays),
    whitened by the circulant basis (``whitened_type='ziggy'``) or the dense
    Cholesky factor of Kmm (``'cholesky'``: M' = M, no spectrum).
    ``family`` is 'mean-field', 'block' or 'full-rank', ``parameterization``
    'expectation-family' (natural parameters; the natgrad step needs it) or
    'standard' ((m, S) stored).  The block family chunks the whitened grid
    (``edims``) into blocks of ``block_sizes`` (one edge per dimension, each
    dividing its dimension; default ``xblock_size`` along every one).  The
    other arguments are the JAX constructor's; ``support_integrated_obs``
    builds the doubly-integrated diagonal's table, which line-integral
    observations need, and ``learn_kernel``/``learn_noise`` are stored as
    the JAX model stores them (the fit's `FitConfig` decides what is
    learned).  ``grid_shards`` pads the circulant embedding so that it
    splits evenly over that many ranks (`parallel.fft_sharded.shard_multiples`;
    M' and the init change, K does not).  Runs on ``device`` (CUDA unless
    the caller asks for the CPU) in ``dtype``."""

    def __init__(
        self,
        kernel,
        xgrids: Sequence,
        num_obs: int,
        family: str = "mean-field",
        whitened_type: str = "ziggy",
        parameterization: str = "expectation-family",
        xblock_size: int = 10,
        block_sizes: Optional[Sequence[int]] = None,
        jitter: float = 1e-3,
        sig2_init: float = 1.0,
        ell_init: float = 0.05,
        noise2_init: float = 1.0,
        init_Svar: float = 0.1,
        learn_kernel: bool = False,
        learn_noise: bool = False,
        support_integrated_obs: bool = False,
        grid_shards: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if family not in ("mean-field", "block", "full-rank"):
            raise ValueError(f"unknown family {family!r}")
        if whitened_type not in ("ziggy", "cholesky"):
            raise ValueError(f"unknown whitened_type {whitened_type!r}")
        if parameterization not in ("expectation-family", "standard"):
            raise ValueError(f"unknown parameterization {parameterization!r}")
        self.kernel = kernel
        self.family = family
        self.whitened_type = whitened_type
        self.parameterization = parameterization
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
        # grid_shards: the circulant embedding padded so that it splits evenly
        # over that many ranks (`parallel/fft_sharded.py`); the padding changes
        # M' and the init, never K
        self.grid_shards = grid_shards
        self._spec_multiple = None
        if whitened_type == "ziggy" and grid_shards and grid_shards > 1:
            from ..parallel.fft_sharded import shard_multiples

            self._spec_multiple = shard_multiples(self.dims, grid_shards)
        self.edims = (embedded_dims(self.dims, self._spec_multiple)
                      if whitened_type == "ziggy" else self.dims)
        self.Mprime = math.prod(self.edims)
        # the block family chunks the whitened grid (the expanded one under
        # 'ziggy'); the tables move to the device once
        self.blk_idx = self.blk_inv = None
        if family == "block":
            if block_sizes is None:
                block_sizes = [xblock_size] * self.ndim
            self.block_sizes = tuple(int(c) for c in block_sizes)
            bidx, binv = blk.block_indices(self.edims, self.block_sizes)
            self.blk_idx = torch.as_tensor(bidx, device=self.device)
            self.blk_inv = torch.as_tensor(binv, device=self.device)
            self.num_blocks, self.block_size = bidx.shape
        self.diag_interp = (DoublyDiagInterpolator(kernel)
                            if support_integrated_obs else None)

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------

    def _scalar(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def init_state(self, generator: Optional[torch.Generator] = None) -> HIPGPState:
        """Glorot-style theta1 drawn from ``generator`` (a CPU generator;
        seed 0 when None; zeros for the full-rank family), theta2 = -I/(2
        init_Svar), or init_Svar I under 'standard', family-shaped."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        Mp, dt, dev = self.Mprime, self.dtype, self.device
        if self.family == "full-rank":
            theta1 = torch.zeros(Mp, dtype=dt)
        else:
            theta1 = math.sqrt(2.0 / (Mp + 1)) * torch.randn(Mp, generator=generator,
                                                             dtype=dt)
        val = (self.init_Svar if self.parameterization == "standard"
               else -0.5 / self.init_Svar)
        if self.family == "mean-field":
            theta2 = torch.full((Mp,), val, dtype=dt, device=dev)
        elif self.family == "block":
            eye = val * torch.eye(self.block_size, dtype=dt, device=dev)
            theta2 = eye.expand(self.num_blocks, -1, -1).clone()
        else:
            theta2 = val * torch.eye(Mp, dtype=dt, device=dev)
        return HIPGPState(
            theta1=theta1.to(dev),
            theta2=theta2,
            log_sig2=self._scalar(math.log(self.sig2_init)),
            log_ell=torch.log(self._scalar(self.ell_init)),
            log_noise2=self._scalar(math.log(self.noise2_init)),
        )

    def kernel_params(self, state: HIPGPState):
        return torch.exp(state.log_sig2), torch.exp(state.log_ell)

    # ------------------------------------------------------------------
    # covariance plumbing
    # ------------------------------------------------------------------

    def spectrum(self, state: HIPGPState, transform: str = "fft") -> BTTBSpectrum:
        """The circulant spectrum at the state's hyperparameters, on the
        embedding padded for ``grid_shards`` (``transform``: `make_spectrum`'s)."""
        p = self.kernel_params(state)
        return make_spectrum(self.xgrids, lambda x, y: self.kernel(x, y, p),
                             jitter=self.jitter, multiple_of=self._spec_multiple,
                             transform=transform)

    def _kmm_chol(self, state: HIPGPState) -> torch.Tensor:
        """Cholesky factor L of Kmm + jitter I (M x M)."""
        Kmm = self.kernel(self.xinduce, self.xinduce, self.kernel_params(state))
        Kmm = Kmm + self.jitter * torch.eye(self.M, dtype=Kmm.dtype, device=Kmm.device)
        return torch.linalg.cholesky(Kmm)

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
                   maxiter_cg: int = 10, tol: float = 1e-8,
                   spec: Optional[BTTBSpectrum] = None) -> torch.Tensor:
        """kn, the whitened cross-covariances (bsz, M'): R^T K^{-1} Kmn by
        PCG (``maxiter_cg``, ``tol``) under 'ziggy', L^{-1} Kmn under
        'cholesky'."""
        if self.whitened_type == "cholesky":
            L = self._kmm_chol(state)
            return torch.linalg.solve_triangular(
                L, Knm.transpose(-1, -2), upper=False).transpose(-1, -2)
        if spec is None:
            spec = self.spectrum(state)
        return whiten(spec, Knm, maxiter=maxiter_cg, tol=tol)

    # ------------------------------------------------------------------
    # variational family
    # ------------------------------------------------------------------

    def standard_params(self, state: HIPGPState):
        """(qm (M',), qS family-shaped) from the stored parameterization; the
        block and full-rank S = (-2 theta2)^{-1} by Cholesky, NaN where
        -2 theta2 is not positive definite (as XLA's)."""
        t1, t2 = state.theta1, state.theta2
        if self.parameterization == "standard":
            return t1, t2
        if self.family == "mean-field":
            S = -0.5 / t2
            return S * t1, S
        S = spd_inverse(-2.0 * t2)
        if self.family == "block":
            return self.block_diag_multiply(S, t1[None, :])[0], S
        with fp32_matmul():
            return S @ t1, S

    def block_diag_multiply(self, S_block: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """The (nb, bs, bs) block-diagonal matrix applied to (bsz, M') rows."""
        vb = blk.to_blocks(v, self.blk_idx)                      # (bsz, nb, bs)
        with fp32_matmul():
            Sv = S_block @ vb.permute(1, 2, 0)                   # (nb, bs, bsz)
        return blk.from_blocks(Sv.permute(2, 0, 1), self.blk_inv)

    def _block_gram(self, kn: torch.Tensor, ivar: Optional[torch.Tensor] = None):
        """sum_n ivar_n knb_n knb_n^T per block, (nb, bs, bs), with knb_n
        row n of kn in block order (ivar None: weights 1): one batched
        product over the block-ordered copy of the rows, gathered at most
        BLOCK_GATHER_BYTES at a time; no (rows, nb, bs, bs) intermediate.
        Full FP32."""
        rows = max(1, BLOCK_GATHER_BYTES // (self.Mprime * kn.element_size()))
        out = None
        with fp32_matmul():
            for r in range(0, kn.shape[0], rows):
                knb = blk.to_blocks(kn[r:r + rows], self.blk_idx)   # (rows, nb, bs)
                lhs = knb if ivar is None else knb * ivar[r:r + rows, None, None]
                part = lhs.permute(1, 2, 0) @ knb.permute(1, 0, 2)
                del knb, lhs
                out = part if out is None else out + part
        return out

    def compute_knSkn(self, kn: torch.Tensor, qS: torch.Tensor) -> torch.Tensor:
        """diag(kn S kn^T) per batch row, S family-shaped."""
        if self.family == "mean-field":
            return torch.sum(kn * qS[None, :] * kn, dim=-1)
        if self.family == "block":
            knb = blk.to_blocks(kn, self.blk_idx).permute(1, 2, 0)   # (nb, bs, bsz)
            with fp32_matmul():
                Skb = qS @ knb
            return torch.sum(knb * Skb, dim=(0, 1))
        with fp32_matmul():
            return torch.sum((kn @ qS) * kn, dim=-1)

    def kl_to_prior(self, qm: torch.Tensor, qS: torch.Tensor) -> torch.Tensor:
        if self.family == "mean-field":
            return stats.diag_kl_to_standard(qm, qS)
        if self.family == "block":
            return stats.block_kl_to_standard(qm, qS)
        return stats.kl_to_standard(qm, qS)

    def get_lam(self, ivar: torch.Tensor, kn: torch.Tensor, bscale=1.0,
                add_identity: bool = True) -> torch.Tensor:
        """The family-shaped Lambda = bscale * sum_n kn_n kn_n^T / sigma_n^2
        (+ I): its diagonal (M',), its diagonal blocks (nb, bs, bs) or the
        whole (M', M').  ``ivar`` (bsz,): the inverse noise variances, zero
        on masked rows."""
        if self.family == "mean-field":
            lam = bscale * torch.sum(ivar[:, None] * kn * kn, dim=0)
            return lam + 1.0 if add_identity else lam
        if self.family == "block":
            lam = bscale * self._block_gram(kn, ivar)
        else:
            with fp32_matmul():
                lam = bscale * ((kn * ivar[:, None]).T @ kn)
        return self._with_identity(lam) if add_identity else lam

    def _lam_zeros(self) -> torch.Tensor:
        """A family-shaped Lambda of zeros."""
        if self.family == "mean-field":
            shape = (self.Mprime,)
        elif self.family == "block":
            shape = (self.num_blocks, self.block_size, self.block_size)
        else:
            shape = (self.Mprime, self.Mprime)
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    def _with_identity(self, lam: torch.Tensor) -> torch.Tensor:
        """lam + I (the prior's precision), family-shaped, a new tensor."""
        if self.family == "mean-field":
            return lam + 1.0
        if self.family == "block":
            return lam + torch.eye(self.block_size, dtype=lam.dtype, device=lam.device)
        out = lam.clone()
        out.diagonal().add_(1.0)
        return out

    def _S_from_lam(self, lam: torch.Tensor) -> torch.Tensor:
        if self.family == "mean-field":
            return 1.0 / lam
        return spd_inverse(lam)

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

    def batch_an(self, state, y, noise_std, kn, Knn_diag, qm, qS,
                 row_sums=None) -> torch.Tensor:
        """Per-point expected log-likelihood
        a_n = -1/(2 s_n^2) [ (kn.m - y)^2 + Knn - kn.kn + kn S kn ]
              - log s_n - 1/2 log 2 pi.
        ``row_sums(kn.m, kn.kn, kn S kn)``: where kn holds a block of M'
        (`parallel.mp`), the three per-row sums over M' summed over the
        blocks, before the squares."""
        y = y.reshape(-1)
        ivar, log_noise_std = self._ivar_and_lognoise(state, noise_std, y.shape[0])
        knt_m = kn @ qm
        knt_kn = torch.sum(kn * kn, dim=-1)
        knSkn = self.compute_knSkn(kn, qS)
        if row_sums is not None:
            knt_m, knt_kn, knSkn = row_sums(knt_m, knt_kn, knSkn)
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

    def _natgrad(self, state, kn, y, ivar, qm, bscale, reduce=None, knt_m=None):
        """(deta1, deta2): natural-gradient ascent directions, family-shaped
        (full-rank: deta1 = b - theta1 with b = kn^T (ivar y), unscaled, as
        in the JAX package).  ``reduce(*sums)`` sums the data terms (the sums
        over the batch's rows) over the ranks that hold its rows; the prior
        terms are added after it, once.  ``knt_m``: kn.qm per row when kn
        holds a block of M' (summed over the blocks)."""
        y = y.reshape(-1)
        if reduce is None:
            reduce = lambda *sums: sums
        if self.family == "full-rank":
            with fp32_matmul():
                gram = (kn * ivar[:, None]).T @ kn
            b, gram = reduce(kn.T @ (ivar * y), gram)
            lam = self._with_identity(bscale * gram)
            return b - state.theta1, -0.5 * lam - state.theta2
        if knt_m is None:
            knt_m = kn @ qm
        bdiff = ivar * (knt_m - y)              # (bsz,)
        if self.family == "mean-field":
            data_dm, lam_sum = reduce(-(kn.T @ bdiff),
                                      torch.sum(ivar[:, None] * kn * kn, dim=0))
            dm = bscale * data_dm - qm
            lam_diag = bscale * lam_sum + 1.0
            dS = -0.5 * lam_diag - state.theta2
            return dm + dS * (-2.0 * qm), dS
        data_dm, lam_sum = reduce(-(kn.T @ bdiff), self._block_gram(kn, ivar))
        dm = bscale * data_dm - qm
        dS = -0.5 * self._with_identity(bscale * lam_sum) - state.theta2
        return dm + self.block_diag_multiply(dS, (-2.0 * qm)[None, :])[0], dS

    def elbo_and_grads(self, state: HIPGPState, x: torch.Tensor,
                       y: torch.Tensor, noise_std: Optional[torch.Tensor] = None,
                       maxiter_cg: int = 10, integrated_obs: bool = False,
                       semi_integrated_estimator: str = "analytic",
                       semi_integrated_samps: int = 10,
                       generator: Optional[torch.Generator] = None,
                       weights: Optional[torch.Tensor] = None,
                       compute_hyper_grads: bool = False, group=None, kn_fn=None):
        """ELBO and natural gradients (and hyperparameter gradients).

        Returns (elbo, grads), ``grads`` a :class:`HIPGPState` in descent
        convention: the theta entries hold -deta, so that
        ``theta - lr * grad = theta + lr * deta``; with
        ``compute_hyper_grads`` the hyperparameter entries hold
        -d elbo / d log_sig2, log_ell, log_noise2 (theta1 and theta2 held
        constant), else zeros.  Needs the expectation-family
        parameterization (ValueError otherwise).

        ``group``: a process group over whose ranks the batch's rows are
        split (`parallel.make_dp_data_shard_fn`).  Every sum over the rows
        is then summed over the group: sum w first, then in one all-reduce
        sum a_n w, the hyper-gradients of the data part and the natural
        gradient's data terms; KL and the prior terms are counted once, and
        every rank returns the same (elbo, grads).

        ``kn_fn(st, x, generator) -> (kn, Knn_diag)`` replaces the whitened
        cross-covariances (JAX's hook; it must be differentiable in the
        hyperparameters ``st`` carries).  The model-parallel layer passes
        `parallel.make_mp_kn_fn`'s, whose kn is this rank's block of M' and
        which carries the grid's process group (``kn_fn.grid_group``) and the
        rank's view of the model (``kn_fn.model``, on which the step then
        runs): the per-row sums over M' are summed over the grid before the
        squares (differentiably: `parallel.mesh.sum_over`), the KL over the
        grid's blocks, the hyper-gradients over the grid, with the terms
        every grid rank computes whole (Knn, the noise) counted from grid
        rank 0 only; the natural gradient stays on the rank's block, its
        data terms summed over ``group``."""
        if self.parameterization != "expectation-family":
            raise ValueError("natural-gradient step needs expectation-family")
        view = getattr(kn_fn, "model", self)
        if view is not self:
            return view.elbo_and_grads(
                state, x, y, noise_std, maxiter_cg=maxiter_cg, integrated_obs=integrated_obs,
                semi_integrated_estimator=semi_integrated_estimator,
                semi_integrated_samps=semi_integrated_samps, generator=generator,
                weights=weights, compute_hyper_grads=compute_hyper_grads, group=group,
                kn_fn=kn_fn)
        grid = getattr(kn_fn, "grid_group", None)
        y = y.reshape(-1)
        hypers = (state.log_sig2, state.log_ell, state.log_noise2)
        if group is not None:
            from ..parallel.mesh import all_reduce

            if weights is None:
                weights = torch.ones_like(y)
            (wsum,) = all_reduce([torch.sum(weights)], group)
        with torch.set_grad_enabled(compute_hyper_grads):
            if compute_hyper_grads:
                hypers = tuple(h.detach().requires_grad_() for h in hypers)
            st = state.replace(theta1=state.theta1.detach(),
                               theta2=state.theta2.detach(), log_sig2=hypers[0],
                               log_ell=hypers[1], log_noise2=hypers[2])
            if kn_fn is not None:
                kn, Knn_diag = kn_fn(st, x, generator)
            else:
                Knm, Knn_diag = self.make_grams(st, x, integrated_obs,
                                                semi_integrated_estimator,
                                                semi_integrated_samps, generator)
                kn = self.compute_kn(st, Knm, maxiter_cg=maxiter_cg)
            qm, qS = self.standard_params(st)
            kl = self.kl_to_prior(qm, qS)
            row_sums, summed, st_an = None, {}, st
            if grid is not None:
                from ..parallel.mesh import all_reduce, sum_over

                def row_sums(*sums):
                    out = sum_over(sums, grid)
                    summed["knt_m"] = out[0].detach()
                    return out

                (kl,) = all_reduce([kl.detach()], grid)
                if compute_hyper_grads and dist.get_rank(grid) != 0:
                    # every grid rank computes these whole: their gradient
                    # enters the grid's sum once, from grid rank 0
                    Knn_diag = Knn_diag.detach()
                    st_an = st.replace(log_noise2=st.log_noise2.detach())
            an = self.batch_an(st_an, y, noise_std, kn, Knn_diag, qm, qS, row_sums=row_sums)
            if group is None:
                elbo = self._mean_an(an, weights) - kl / self.N
            else:
                # this rank's share of the data term (KL is added once below)
                an_sum = torch.sum(an * weights)
                elbo = an_sum / torch.clamp(wsum, min=1.0)
        if compute_hyper_grads:
            hgrads = torch.autograd.grad(elbo, hypers, allow_unused=True)
            g_sig2, g_ell, g_noise2 = (torch.zeros_like(h) if g is None else -g
                                       for g, h in zip(hgrads, hypers))
            if grid is not None:
                # each grid rank holds its share (`parallel.mesh.sum_over`)
                g_sig2, g_ell, g_noise2 = all_reduce([g_sig2, g_ell, g_noise2], grid)
            elbo, kn = elbo.detach(), kn.detach()
        else:
            g_sig2, g_ell, g_noise2 = (torch.zeros_like(h) for h in hypers)

        ivar, _ = self._ivar_and_lognoise(state, noise_std, y.shape[0])
        reduce = None
        if weights is not None:
            ivar = ivar * weights
            wtot = torch.sum(weights) if group is None else wsum
            bscale = self.N / torch.clamp(wtot, min=1.0)
        else:
            bscale = self.N / y.shape[0]
        if group is not None:
            scalars = {}

            def reduce(*sums):
                out = all_reduce([an_sum.detach(), g_sig2, g_ell, g_noise2, *sums], group)
                scalars.update(zip(("an_sum", "g_sig2", "g_ell", "g_noise2"), out[:4]))
                return out[4:]

        deta1, deta2 = self._natgrad(state, kn, y, ivar, qm, bscale, reduce,
                                     knt_m=summed.get("knt_m"))
        if group is not None:
            g_sig2, g_ell, g_noise2 = scalars["g_sig2"], scalars["g_ell"], scalars["g_noise2"]
            with torch.no_grad():
                elbo = scalars["an_sum"] / torch.clamp(wsum, min=1.0) - kl.detach() / self.N
        grads = HIPGPState(
            theta1=-deta1,
            theta2=-deta2,
            log_sig2=g_sig2,
            log_ell=g_ell,
            log_noise2=g_noise2,
        )
        return elbo, grads

    # ------------------------------------------------------------------
    # closed-form full-batch solve
    # ------------------------------------------------------------------

    @torch.no_grad()
    def accumulate_lam_b(self, state: HIPGPState, x: torch.Tensor, y: torch.Tensor,
                         ivar: torch.Tensor, maxiter_cg: int = 10,
                         integrated_obs: bool = False,
                         semi_integrated_estimator: str = "analytic",
                         semi_integrated_samps: int = 10,
                         generator: Optional[torch.Generator] = None,
                         spec: Optional[BTTBSpectrum] = None,
                         big: Optional[torch.Tensor] = None):
        """One batch's additive contributions to the information-form solve:
        (lam, b, big) WITHOUT prior identities, with lam the family-shaped
        sum ivar kn kn^T (`get_lam`), b = kn^T (ivar y) and big = sum ivar
        kn kn^T (M' x M'; None for the full-rank family, whose lam is that
        matrix).  ``ivar`` is the per-row inverse noise variance with any
        padding mask folded in.  With ``big`` given, the batch's Gram is
        added to it in place (the dense solve's one accumulator) and it is
        returned; kn is freed on return either way.  No graph is recorded."""
        Knm, _ = self.make_grams(state, x, integrated_obs, semi_integrated_estimator,
                                 semi_integrated_samps, generator)
        kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg, spec=spec)
        del Knm
        lam = self.get_lam(ivar, kn, bscale=1.0, add_identity=False)
        b = kn.T @ (ivar * y.reshape(-1))
        if self.family == "full-rank":
            return lam, b, None
        # sum ivar kn kn^T as (s kn)^T (s kn), s = sqrt(ivar), with kn scaled
        # in place: no second (bsz, M') buffer beside the M' x M' accumulator
        kn.mul_(torch.sqrt(ivar)[:, None])
        with fp32_matmul():
            if big is None:
                big = kn.T @ kn
            else:
                big.addmm_(kn.T, kn)
        return lam, b, big

    @torch.no_grad()
    def finalize_from_lam_b(self, state: HIPGPState, lam: torch.Tensor,
                            b: torch.Tensor, big: Optional[torch.Tensor]) -> HIPGPState:
        """Turn accumulated (lam, b, big), prior identities NOT included,
        into the optimal variational state: Lambda = lam + I (family-shaped)
        and the mean mhat from (big + I) mhat = b, stored as theta2 =
        -Lambda/2 and theta1 = Lambda mhat, or under 'standard' as
        (mhat, Lambda^{-1}).  The full-rank family needs no ``big`` (None):
        theta1 = b, or mhat = Lambda^{-1} b.  The identity is added to
        ``big`` in place, and only its Cholesky factor is allocated beside
        it."""
        lam = self._with_identity(lam)
        if big is not None:
            big.diagonal().add_(1.0)
        if self.parameterization == "standard":
            S = self._S_from_lam(lam)
            if self.family == "full-rank":
                with fp32_matmul():
                    m = S @ b
            else:
                m = spd_solve(big, b)
            return state.replace(theta1=m, theta2=S)
        if self.family == "full-rank":
            return state.replace(theta1=b, theta2=-0.5 * lam)
        return self._natural_state(state, lam, spd_solve(big, b))

    def _natural_state(self, state, lam_with_I, mhat):
        """theta2 = -Lambda/2, theta1 = Lambda mhat (mean-field, block)."""
        if self.family == "mean-field":
            theta1 = mhat * lam_with_I
        else:
            theta1 = self.block_diag_multiply(lam_with_I, mhat[None, :])[0]
        return state.replace(theta1=theta1, theta2=-0.5 * lam_with_I)

    def _state_from_lam_mhat(self, state: HIPGPState, lam: torch.Tensor,
                             mhat: torch.Tensor) -> HIPGPState:
        """The optimal state from the accumulated family-shaped Lambda
        (WITHOUT the prior identity) and the already-solved optimal mean
        mhat: the shared tail of the 'cg', 'gram', 'factored' and 'matfree'
        mean solvers."""
        lam_with_I = self._with_identity(lam)
        if self.parameterization == "standard":
            return state.replace(theta1=mhat, theta2=self._S_from_lam(lam_with_I))
        return self._natural_state(state, lam_with_I, mhat)

    def _gram_sweep(self, state, spec, batches, flags, maxiter_cg, kn=True, gram=True,
                    draws=None):
        """The one data sweep of the 'gram' solver: per-point kn for Lambda
        (the reference's truncation semantics) and, beside it, the
        original-space data Gram A = sum ivar Knm Knm^T (M x M), b_m =
        sum ivar y Knm and the four ELBO scalars sum ivar y^2,
        sum ivar Knn, sum ivar kn.kn and sum w (-log s - log(2 pi)/2).
        A and b_m are accumulated in full FP32 (no TF32): the Woodbury mean
        and the ELBO's data quadratic are differences of large terms, so
        they and the four scalars are summed in GRAM_ACC_DTYPE (float64: on
        the H100 a DGEMM runs on the FP64 tensor cores at the FP32 rate).
        Returns (lam, A, b_m, sum ivar y^2, sum ivar Knn, sum ivar kn.kn,
        sum of the log terms).  Without ``kn`` no whitening runs and lam and
        sum ivar kn.kn are None ('factored'); without ``gram`` A is None
        ('matfree').  ``draws``, a list, receives the generator's state
        before each batch, so that a later sweep can replay its draws."""
        xb, yb, w, nsp = batches
        acc, dev = GRAM_ACC_DTYPE, self.device
        lam = self._lam_zeros() if kn else None
        A = torch.zeros((self.M, self.M), dtype=acc, device=dev) if gram else None
        bm = torch.zeros((self.M,), dtype=acc, device=dev)
        sy2, sKnn, sknkn, slog = (torch.zeros((), dtype=acc, device=dev) for _ in range(4))
        for i in range(xb.shape[0]):
            if draws is not None:
                draws.append(flags["generator"].get_state())
            Knm, Knn = self.make_grams(state, xb[i], **flags)
            yv, wb, nsb = yb[i], w[i], nsp[i]
            ivar = wb / (nsb * nsb)
            if kn:
                kn_i = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg, spec=spec)
                lam += self.get_lam(ivar, kn_i, bscale=1.0, add_identity=False)
                with fp32_matmul():
                    knkn = torch.einsum("bi,bi->b", kn_i, kn_i)
                del kn_i
            Knm, ivar, yv = Knm.to(acc), ivar.to(acc), yv.to(acc)
            if gram:
                A.addmm_(Knm.T, Knm * ivar[:, None])
            bm += Knm.T @ (ivar * yv)
            del Knm
            if kn:
                sknkn += torch.sum(ivar * knkn)
            sy2 += torch.sum(ivar * yv * yv)
            sKnn += torch.sum(ivar * Knn.reshape(-1))
            slog += torch.sum(wb.to(acc) * (-torch.log(nsb.to(acc)) - 0.5 * LN2PI))
        return lam, A, bm, sy2, sKnn, sknkn if kn else None, slog

    def _gram_mean_stage(self, state, spec, A, bm, maxiter, tol):
        """(mhat, z) with z = (K + A)^{-1} b_m: under 'ziggy' by PCG on K + A
        with the circulant preconditioner, mhat = R^T z; under 'cholesky'
        by a dense SPD solve of Kmm + A, mhat = L^T z.  In A's dtype (the
        model's Kmm or spectrum cast to it); mhat comes back in the model's
        dtype, z in A's."""
        acc = A.dtype
        if self.whitened_type == "cholesky":
            Kmm = self.kernel(self.xinduce, self.xinduce, self.kernel_params(state)).to(acc)
            Kmm = Kmm + self.jitter * torch.eye(self.M, dtype=acc, device=Kmm.device)
            z = spd_solve(Kmm + A, bm)
            return (self._kmm_chol(state).to(acc).T @ z).to(self.dtype), z
        spec = _cast_spec(spec, acc)

        def kpa_mv(v):
            with fp32_matmul():
                return matmul_by_K(spec, v) + v @ A

        z = _mean_pcg(kpa_mv, bm, lambda v: matmul_by_Cinv(spec, v), maxiter, tol)
        return matmul_by_RT(spec, z[None, :])[0].to(self.dtype), z

    def _gram_elbo_stage(self, z, zAz, bm, sy2, sKnn, sknkn, slog, lam, new_state, N):
        """The ELBO from the sweep's accumulators: kn.m = Knm (K+A)^{-1} b_m
        exactly (R R^T = K), so the data quadratic collapses onto
        (z^T A z, b_m, z); sum ivar kn.kn (or 'factored''s tr(K^{-1} A)) and
        sum ivar kn S kn = sum(S * Lambda) come from the sweep.  Summed in
        z's dtype, returned in the model's."""
        acc = z.dtype
        qm, qS = self.standard_params(new_state)
        quad = zAz - 2.0 * (z @ bm) + sy2
        sSkn = torch.sum(qS.to(acc) * lam.to(acc))
        total_an = -0.5 * (quad + sKnn - sknkn + sSkn) + slog
        kl = self.kl_to_prior(qm.to(acc), qS.to(acc))
        return (total_an / N - kl / self.N).to(self.dtype)

    def _batch_solve_gram(self, state, spec, batches, N, flags, clock, *,
                          maxiter_cg, mean_solver_maxiter, mean_solver_tol,
                          compute_elbo):
        """The one-sweep 'gram' solver: `_gram_sweep` (per-point kn for
        Lambda, and A, b_m and the ELBO scalars beside it), `_gram_mean_stage`
        (the Woodbury mean m = R (K + A)^{-1} b_m), `_gram_elbo_stage`; no
        second sweep."""
        lam, A, bm, sy2, sKnn, sknkn, slog = self._gram_sweep(
            state, spec, batches, flags, maxiter_cg)
        clock.mark("sweep")
        mhat, z = self._gram_mean_stage(state, spec, A, bm, mean_solver_maxiter,
                                        mean_solver_tol)
        new_state = self._state_from_lam_mhat(state, lam, mhat)
        clock.mark("mean")
        if not compute_elbo:
            return new_state
        elbo = self._gram_elbo_stage(z, z @ (A @ z), bm, sy2, sKnn, sknkn, slog, lam,
                                     new_state, N)
        clock.mark("elbo")
        return new_state, elbo

    def _lam_from_factor_rows(self, G: torch.Tensor) -> torch.Tensor:
        """The family-shaped sum_k g_k g_k^T (no prior identity) from factor
        rows G, row k being (W l_k)^T with A = sum_k l_k l_k^T."""
        if self.family == "mean-field":
            return torch.sum(G * G, dim=0)
        if self.family == "block":
            return self._block_gram(G)
        with fp32_matmul():
            return G.T @ G

    def factor_data_gram(self, A: torch.Tensor, factor_jitter: Optional[float] = None):
        """(L_A, eps): the Cholesky factor of A + eps I with the relative
        jitter eps = factor_jitter * mean(diag A), raised x100 up to 4 times
        while the factor fails, then FloatingPointError.  By default
        factor_jitter is keyed on the dtype of the factor, A's: 1e-4 for
        float32, 1e-10 otherwise.  The JAX package keys it on the model's
        dtype, but the port factors A in GRAM_ACC_DTYPE (float64), where
        1e-4 would only bias Lambda by eps diag(K^{-1}); pass
        ``factor_jitter=1e-4`` for the JAX package's float32 shift.  In A's
        dtype; only the shifted copy and its factor are allocated."""
        if factor_jitter is None:
            factor_jitter = 1e-4 if A.dtype == torch.float32 else 1e-10
        eps = factor_jitter * torch.mean(torch.diagonal(A))

        def chol_at(e):
            shifted = A.clone()
            shifted.diagonal().add_(e)
            L, info = torch.linalg.cholesky_ex(shifted)
            del shifted
            return L if int(info) == 0 and bool(torch.isfinite(L).all()) else None

        L_A, tries = chol_at(eps), 0
        while L_A is None and tries < 4:
            eps, tries = eps * 100.0, tries + 1
            L_A = chol_at(eps)
        if L_A is None:
            raise FloatingPointError(
                "factored mean solver: Cholesky of the accumulated data Gram stayed "
                f"non-finite up to jitter {float(eps):.3e}; raise factor_jitter (A is "
                "PSD only up to accumulation roundoff)")
        return L_A, float(eps)

    def _factored_g_stage(self, state, spec, L_A, maxiter_cg):
        """(Lambda - I, tr(K^{-1} A)) from G = W L_A: the rows of L_A^T
        whitened by `compute_kn` (under 'ziggy' in chunks of FACTOR_CHUNK
        rows, the last padded with zero rows as JAX pads it; under
        'cholesky' in one triangular solve), the family-shaped Lambda summed
        over the chunks in the model's dtype and the trace ||G||_F^2 in
        GRAM_ACC_DTYPE."""
        Lt = L_A.T
        ncols = Lt.shape[0]
        cs = ncols if self.whitened_type == "cholesky" else min(ncols, FACTOR_CHUNK)
        lam = self._lam_zeros()
        tr = torch.zeros((), dtype=GRAM_ACC_DTYPE, device=self.device)
        for c in range(0, ncols, cs):
            rows = Lt[c:c + cs]
            if rows.shape[0] < cs:
                rows = torch.cat([rows, rows.new_zeros((cs - rows.shape[0], self.M))])
            G = self.compute_kn(state, rows.contiguous(), maxiter_cg=maxiter_cg, spec=spec)
            sq = torch.sum(G * G, dim=0)
            lam += sq if self.family == "mean-field" else self._lam_from_factor_rows(G)
            del G
            tr += torch.sum(sq.to(GRAM_ACC_DTYPE))
        return lam, tr

    def _batch_solve_factored(self, state, spec, batches, N, flags, clock, *,
                              maxiter_cg, mean_solver_maxiter, mean_solver_tol,
                              compute_elbo, factor_jitter):
        """The closed form with M whitening solves instead of N: every
        quantity of the optimum is a function of the data Gram A and b_m
        (W = R^T K^{-1} with K = R R^T exactly for the clamped circulant):

        * Lambda - I = W A W^T, the squared column sums of G = W L_A with
          A = L_A L_A^T (`factor_data_gram`, `_factored_g_stage`);
        * the mean m = R (K + A)^{-1} b_m (`_gram_mean_stage`; the full-rank
          family solves no mean: theta1 = W b_m, `finalize_from_lam_b`);
        * the ELBO as 'gram''s with sum ivar kn.kn = tr(K^{-1} A) = ||G||_F^2
          (full-rank: with v = K^{-1} R qm in place of z).

        The data sweep runs no PCG (`_gram_sweep` without kn).  Checks, in
        order: the pre-check (float32 under 'ziggy': kappa of the spectrum
        at most FACTORED_F32_KAPPA_MAX, else the localized factor columns'
        float32 solves cannot resolve the tail Lambda needs), the trace
        guard tr(K^{-1} A) <= 1.2 sum ivar Knn + 1e-6, and with the ELBO the
        bracket guard (the summed variance terms are not below -1e-3
        sum ivar Knn); each raises FactoredSolveInconsistency (the guards
        only while FACTORED_GUARDS), and FACTORED_STATS records them.  A is
        summed and factored in GRAM_ACC_DTYPE, the factor whitened in the
        model's dtype."""
        stats = FACTORED_STATS
        stats.update(dict.fromkeys(stats, float("nan")))
        if spec is not None:
            kappa = float(torch.max(spec.eigs) / torch.min(spec.eigs))
            stats["kappa"] = kappa
            if self.dtype == torch.float32 and kappa > FACTORED_F32_KAPPA_MAX:
                raise FactoredSolveInconsistency(
                    f"spectrum dynamic range {kappa:.2e} exceeds the measured f32 trust "
                    f"region ({FACTORED_F32_KAPPA_MAX:g}): the f32 whitening solves of "
                    "the LOCALIZED factor columns cannot resolve the spectral tail "
                    "that Lambda needs (the bound is a property of the solves, not "
                    "the factor)")
        _, A, bm, sy2, sKnn, _, slog = self._gram_sweep(state, spec, batches, flags,
                                                        maxiter_cg, kn=False)
        clock.mark("sweep")
        L_A, stats["jitter"] = self.factor_data_gram(A, factor_jitter)
        clock.mark("factor")
        lam, tr = self._factored_g_stage(state, spec, L_A.to(self.dtype), maxiter_cg)
        del L_A
        clock.mark("g")
        tr_f, sk_f = float(tr), float(sKnn)
        stats.update(trKinvA=tr_f, sKnn=sk_f)
        if FACTORED_GUARDS and (not math.isfinite(tr_f) or tr_f > 1.2 * sk_f + 1e-6):
            raise FactoredSolveInconsistency(
                f"tr(K^-1 A) = {tr_f:.4e} exceeds sum ivar Knn = {sk_f:.4e}: the "
                "factor-column PCG solves are inconsistent at this conditioning "
                "(clamped spectrum / f32); use the 'gram' sweep solver or raise "
                "maxiter_cg")
        if self.family == "full-rank":
            # no mean solve: b_m whitened, then finalize_from_lam_b
            bw = self.compute_kn(state, bm.to(self.dtype)[None, :],
                                 maxiter_cg=mean_solver_maxiter, spec=spec)[0]
            new_state, z = self.finalize_from_lam_b(state, lam, bw, None), None
        else:
            mhat, z = self._gram_mean_stage(state, spec, A, bm, mean_solver_maxiter,
                                            mean_solver_tol)
            new_state = self._state_from_lam_mhat(state, lam, mhat)
        clock.mark("mean")
        if not compute_elbo:
            return new_state
        qm, qS = self.standard_params(new_state)
        if z is None:
            # kn.m = Knm v with v = K^{-1} R qm (ziggy), L^{-T} qm (cholesky)
            if self.whitened_type == "cholesky":
                v = torch.linalg.solve_triangular(self._kmm_chol(state).T, qm[:, None],
                                                  upper=True)[:, 0]
            else:
                v = inv_matmul(spec, matmul_by_R(spec, qm[None, :]),
                               maxiter=mean_solver_maxiter, tol=mean_solver_tol)[0]
            z = v.to(A.dtype)
        bracket = sk_f - tr_f + float(torch.sum(qS.to(tr.dtype) * lam.to(tr.dtype)))
        stats["bracket"] = bracket
        if FACTORED_GUARDS and bracket < -1e-3 * sk_f:
            raise FactoredSolveInconsistency(
                f"aggregate variance bracket {bracket:.4e} is negative (sKnn "
                f"{sk_f:.4e}, tr {tr_f:.4e}): the closed-form ELBO is invalid at "
                "this conditioning")
        elbo = self._gram_elbo_stage(z, z @ (A @ z), bm, sy2, sKnn, tr, slog, lam,
                                     new_state, N)
        clock.mark("elbo")
        return new_state, elbo

    def _batch_solve_matfree(self, state, spec, batches, N, flags, clock, *,
                             maxiter_cg, mean_solver_maxiter, mean_solver_tol,
                             compute_elbo):
        """'gram' without the M x M data Gram: the sweep accumulates Lambda,
        b_m and the ELBO scalars (`_gram_sweep` without A), and each
        iteration of the host-driven PCG on (K + A) z = b_m applies A by
        sweeping the data again, Knm rebuilt batch by batch (the draws of
        the Monte-Carlo estimator replayed) and freed; it stops once
        ||r||^2 <= mean_solver_tol^2 ||b_m||^2, checked on the host after
        every update.  m = R^T z; the ELBO's z^T A z comes from one more
        sweep.  Memory O(M + bsz M), the solver of the paper-scale 3-D
        grids.  The A applies and the PCG run in GRAM_ACC_DTYPE."""
        if self.whitened_type != "ziggy":
            raise ValueError("mean_solver='matfree' requires ziggy whitening")
        xb, _, w, nsp = batches
        draws = [] if flags["generator"] is not None else None
        lam, _, bm, sy2, sKnn, sknkn, slog = self._gram_sweep(
            state, spec, batches, flags, maxiter_cg, gram=False, draws=draws)
        clock.mark("sweep")
        acc = GRAM_ACC_DTYPE
        spec = _cast_spec(spec, acc)
        ivars = [(w[i] / (nsp[i] * nsp[i])).to(acc) for i in range(xb.shape[0])]

        def a_mv(v):
            # sum_n ivar_n Knm_n (Knm_n . v), Knm rebuilt: no M x M tensor
            out = torch.zeros_like(v)
            for i in range(xb.shape[0]):
                if draws is not None:
                    flags["generator"].set_state(draws[i])
                Knm = self.make_grams(state, xb[i], **flags)[0].to(acc)
                with fp32_matmul():
                    out += (ivars[i] * (Knm @ v)) @ Knm
                del Knm
            return out

        def k_mv(v):
            with fp32_matmul():
                return matmul_by_K(spec, v[None, :])[0]

        cinv = lambda v: matmul_by_Cinv(spec, v[None, :])[0]
        z, r = torch.zeros_like(bm), bm
        p = cinv(r)
        rz, b2 = torch.dot(r, p), torch.dot(bm, bm)
        rtol2 = mean_solver_tol ** 2 * b2
        iters = 0
        for _ in range(mean_solver_maxiter):
            Ap = k_mv(p) + a_mv(p)
            alpha = rz / torch.dot(p, Ap)
            z = z + alpha * p
            r = r - alpha * Ap
            y = cinv(r)
            rz_new = torch.dot(r, y)
            p = y + (rz_new / rz) * p
            rz, iters = rz_new, iters + 1
            if bool(torch.dot(r, r) <= rtol2):
                break
        MEAN_PCG_STATS.update(iterations=iters, resnorm=float(r.norm()),
                              bnorm=float(b2.sqrt()))
        mhat = matmul_by_RT(spec, z[None, :])[0].to(self.dtype)
        new_state = self._state_from_lam_mhat(state, lam, mhat)
        clock.mark("mean")
        if not compute_elbo:
            return new_state
        elbo = self._gram_elbo_stage(z, z @ a_mv(z), bm, sy2, sKnn, sknkn, slog, lam,
                                     new_state, N)
        clock.mark("elbo")
        return new_state, elbo

    @torch.no_grad()
    def batch_solve(self, state: HIPGPState, xobs, yobs, noise_std=None,
                    batch_size: int = -1, maxiter_cg: int = 10,
                    integrated_obs: bool = False,
                    semi_integrated_estimator: str = "analytic",
                    semi_integrated_samps: int = 10,
                    generator: Optional[torch.Generator] = None,
                    compute_elbo: bool = False, mean_solver: str = "dense",
                    mean_solver_maxiter: int = 200, mean_solver_tol: float = 1e-8,
                    factor_jitter: Optional[float] = None,
                    timings: Optional[dict] = None):
        """Closed-form optimal q: accumulate (Lambda, b) over batches of
        ``batch_size`` rows (-1: one batch), then S = Lambda^{-1}, m = S b.
        Returns ``new_state``, or ``(new_state, elbo)`` with ``compute_elbo``.

        The data are padded to a batch multiple and masked (zero weights,
        noise padded with 1); without ``noise_std`` the rows' inverse noise
        variance is w exp(-log_noise2).  ``generator`` draws the Monte-Carlo
        estimator's points.  ``mean_solver`` decides how the mean-field and
        block families' optimal mean solves (I + sum_n ivar_n kn_n kn_n^T)
        m = b (the full-rank family's Lambda is that matrix: every solver but
        'factored' accumulates it and b in one sweep, with a second sweep for
        the ELBO; `finalize_from_lam_b`):

        * 'dense' holds that M' x M' matrix (accumulated, and the identity
          added, in place; factored by Cholesky with only its factor beside
          it) and re-whitens the data in a second sweep for the ELBO;
        * 'cg' keeps the stacked kn (N x M') and solves by CG with matvecs
          m -> m + kn^T (ivar * (kn m)); the ELBO reuses the stacked kn;
        * 'gram' sweeps the data once, accumulating the original-space data
          Gram A = sum_n ivar_n Knm_n Knm_n^T (M x M) beside Lambda, and
          solves m = R (K + A)^{-1} b_m (the Woodbury collapse, exact;
          `_gram_mean_stage`); the ELBO comes from the sweep's scalars;
        * 'factored' takes Lambda and the ELBO from A as well, through the
          Cholesky factor of A (``factor_jitter``: its relative jitter) and
          M whitening solves instead of N (`_batch_solve_factored`); when an
          exactness check fails it warns (RuntimeWarning) and runs 'gram';
        * 'matfree' is 'gram' without A: every iteration of its mean PCG
          applies A by sweeping the data again (`_batch_solve_matfree`;
          'ziggy' only).

        ``timings``, a dict, receives the seconds of each stage, the card
        synchronised at each boundary: 'sweep', 'mean', 'elbo'; 'factored'
        adds 'factor' (A's Cholesky) and 'g' (the factor's whitening) after
        'sweep', and a fallback keeps the failed attempt's stages as
        'factored_<stage>'."""
        if mean_solver not in ("dense", "cg", "gram", "factored", "matfree"):
            raise ValueError(f"mean_solver={mean_solver!r}")
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=self.device)
        x = as_t(xobs)
        N = x.shape[0]
        xb, yb, sb, w = prepare_batches(
            x, as_t(yobs), None if noise_std is None else as_t(noise_std),
            batch_size if 0 < batch_size < N else N)
        flags = dict(integrated_obs=integrated_obs,
                     semi_integrated_estimator=semi_integrated_estimator,
                     semi_integrated_samps=semi_integrated_samps, generator=generator)
        clock = _StageClock(timings, self.device)
        spec = self.spectrum(state) if self.whitened_type == "ziggy" else None
        # the sweep-based solvers' rows: without noise_std the noise is
        # exp(log_noise2 / 2), the homoscedastic case of the same formulas
        nsp = torch.exp(0.5 * state.log_noise2) * torch.ones_like(w) if sb is None else sb
        kw = dict(maxiter_cg=maxiter_cg, mean_solver_maxiter=mean_solver_maxiter,
                  mean_solver_tol=mean_solver_tol, compute_elbo=compute_elbo)
        if mean_solver == "factored":
            try:
                return self._batch_solve_factored(state, spec, (xb, yb, w, nsp), N, flags,
                                                  clock, factor_jitter=factor_jitter, **kw)
            except FactoredSolveInconsistency as e:
                warnings.warn(
                    f"factored batch solve failed its exactness check ({e}); falling "
                    "back to the sweep-based 'gram' solver", RuntimeWarning)
                if timings is not None:
                    for k in [k for k in timings if not k.startswith("factored_")]:
                        timings["factored_" + k] = timings.pop(k)
                clock = _StageClock(timings, self.device)
                mean_solver = "gram"
        # 'gram' and 'matfree' solve the mean-field and block families' mean;
        # the full-rank family takes the generic accumulation below
        if mean_solver == "matfree" and self.family != "full-rank":
            return self._batch_solve_matfree(state, spec, (xb, yb, w, nsp), N, flags,
                                             clock, **kw)
        if mean_solver == "gram" and self.family != "full-rank":
            return self._batch_solve_gram(state, spec, (xb, yb, w, nsp), N, flags, clock,
                                          **kw)

        def ivar_of(i):
            if sb is not None:
                return w[i] / (sb[i] * sb[i])
            return w[i] * torch.exp(-state.log_noise2)

        need_big = self.family != "full-rank" and mean_solver == "dense"
        collect_kn = self.family != "full-rank" and mean_solver == "cg"
        lam = self._lam_zeros()
        b = torch.zeros((self.Mprime,), dtype=self.dtype, device=self.device)
        if not collect_kn:
            big = (torch.zeros((self.Mprime, self.Mprime), dtype=self.dtype,
                               device=self.device) if need_big else None)
            for i in range(xb.shape[0]):
                lam_i, b_i, big = self.accumulate_lam_b(
                    state, xb[i], yb[i], ivar_of(i), maxiter_cg=maxiter_cg,
                    spec=spec, big=big, **flags)
                lam += lam_i
                b += b_i
                del lam_i
            clock.mark("sweep")
            new_state = self.finalize_from_lam_b(state, lam, b, big)
            del big
            clock.mark("mean")
        else:
            kns, ivars = [], []
            for i in range(xb.shape[0]):
                Knm, _ = self.make_grams(state, xb[i], **flags)
                kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg, spec=spec)
                ivar = ivar_of(i)
                lam += self.get_lam(ivar, kn, bscale=1.0, add_identity=False)
                b += kn.T @ (ivar * yb[i])
                kns.append(kn)
                ivars.append(ivar)
            kn_all, ivar_all = torch.cat(kns), torch.cat(ivars)
            clock.mark("sweep")

            def big_mv(v):
                # v + kn^T diag(ivar) kn v, never forming the M' x M' Gram
                with fp32_matmul():
                    return v + (ivar_all * (kn_all @ v.T).T) @ kn_all

            mhat = _mean_pcg(big_mv, b, None, mean_solver_maxiter, mean_solver_tol)
            new_state = self._state_from_lam_mhat(state, lam, mhat)
            clock.mark("mean")
        if not compute_elbo:
            return new_state

        qm, qS = self.standard_params(new_state)
        params = self.kernel_params(new_state)
        total_an = torch.zeros((), dtype=self.dtype, device=self.device)
        bsz = xb.shape[1]
        for i in range(xb.shape[0]):
            if collect_kn:
                # the stacked kn of the solve: only the prior diagonal is new
                kn = kn_all[i * bsz:(i + 1) * bsz]
                Knn = (self.diag_interp(xb[i], params) if integrated_obs
                       else self.kernel.diag(xb[i], params))
            else:
                Knm, Knn = self.make_grams(state, xb[i], **flags)
                kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg, spec=spec)
            an = self.batch_an(new_state, yb[i], None if sb is None else sb[i], kn,
                               Knn, qm, qS)
            total_an = total_an + torch.sum(an * w[i])
        elbo = total_an / N - self.kl_to_prior(qm, qS) / self.N
        clock.mark("elbo")
        return new_state, elbo

    # ------------------------------------------------------------------
    # prediction
    # ------------------------------------------------------------------

    def predict(self, state: HIPGPState, x: torch.Tensor, maxiter_cg: int = 50,
                integrated_obs: bool = False,
                semi_integrated_estimator: str = "analytic",
                semi_integrated_samps: int = 10,
                generator: Optional[torch.Generator] = None,
                var_clamp: float = VAR_CLAMP):
        """(mu*, sig*): posterior mean and marginal std at x (of the line
        integrals with ``integrated_obs``); the latent variance Knn - kn.kn
        is floored at ``var_clamp``."""
        Knm, Knn_diag = self.make_grams(state, x, integrated_obs,
                                        semi_integrated_estimator,
                                        semi_integrated_samps, generator)
        kn = self.compute_kn(state, Knm, maxiter_cg=maxiter_cg)
        qm, qS = self.standard_params(state)
        mu = kn @ qm
        ktilde = torch.clamp(Knn_diag.reshape(-1) - torch.sum(kn * kn, dim=-1),
                             min=var_clamp)
        sig = torch.sqrt(ktilde + self.compute_knSkn(kn, qS))
        return mu, sig

    def get_inducing_S(self, state: HIPGPState) -> torch.Tensor:
        """R S R^T (M, M): the variational covariance mapped back to the
        original inducing space (full-rank family only; ValueError
        otherwise)."""
        if self.family != "full-rank":
            raise ValueError("get_inducing_S is defined for the full-rank family")
        _, S = self.standard_params(state)
        spec = self.spectrum(state)
        v = matmul_by_R(spec, S)            # rows: (M', M') -> (M', M)
        return matmul_by_R(spec, v.T)       # (M, M)
