"""Full-covariance GMMs.

Parity target: src/gmm/full-gmm.h (FullGmm), mle-full-gmm.h
(AccumFullGmm / MleFullGmmUpdate).  Used by the reference mainly as the
UBM for i-vector systems (full-UBM stage of steps/train_diag_ubm.sh →
train_full_ubm.sh).

Device layout: per-pdf tensors (P, M, D, D) with precomputed Cholesky
inverses; log-likelihoods batch as einsums — the quadratic form
xᵀ Σ⁻¹ x is one (T,D)·(M,D,D) contraction on the matrix units.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)

_LOG_2PI = math.log(2.0 * math.pi)


class FullGmm:
    """Single-state full-covariance GMM (the UBM role)."""

    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 covars: np.ndarray):
        """weights (M,), means (M, D), covars (M, D, D)."""
        self.weights = weights.astype(np.float64)
        self.means = means.astype(np.float64)
        self.covars = covars.astype(np.float64)
        self.refresh()

    @property
    def num_mix(self) -> int:
        return len(self.weights)

    @property
    def dim(self) -> int:
        return self.means.shape[1]

    def refresh(self) -> None:
        M, D = self.means.shape
        self.inv_covars = np.zeros_like(self.covars)
        self.gconsts = np.zeros(M)
        for m in range(M):
            c = self.covars[m] + 1e-8 * np.eye(D)
            L = np.linalg.cholesky(c)
            self.inv_covars[m] = np.linalg.inv(c)
            logdet = 2.0 * np.log(np.diag(L)).sum()
            mu = self.means[m]
            self.gconsts[m] = (np.log(max(self.weights[m], 1e-300))
                               - 0.5 * (D * _LOG_2PI + logdet
                                        + mu @ self.inv_covars[m] @ mu))

    def component_loglikes(self, x: np.ndarray) -> np.ndarray:
        """(T, D) → (T, M) per-component log-likelihoods."""
        x = np.asarray(x, np.float64)
        lin = np.einsum("md,mde,te->tm", self.means, self.inv_covars, x)
        quad = -0.5 * np.einsum("td,mde,te->tm", x, self.inv_covars, x)
        return self.gconsts[None, :] + lin + quad

    def loglikes(self, x: np.ndarray) -> np.ndarray:
        comp = self.component_loglikes(x)
        mx = comp.max(axis=1, keepdims=True)
        return (mx[:, 0] + np.log(np.exp(comp - mx).sum(axis=1)))

    def posteriors(self, x: np.ndarray) -> np.ndarray:
        comp = self.component_loglikes(x)
        comp -= comp.max(axis=1, keepdims=True)
        p = np.exp(comp)
        return p / p.sum(axis=1, keepdims=True)

    @staticmethod
    def from_diag(weights: np.ndarray, means: np.ndarray,
                  variances: np.ndarray) -> "FullGmm":
        """Initialize from a diagonal GMM (train_full_ubm.sh start)."""
        M, D = means.shape
        covars = np.zeros((M, D, D))
        for m in range(M):
            covars[m] = np.diag(variances[m])
        return FullGmm(weights, means, covars)


class AccumFullGmm:
    """Sufficient stats: occupancy, Σγx, Σγxxᵀ (mle-full-gmm.h)."""

    def __init__(self, num_mix: int, dim: int):
        self.occ = np.zeros(num_mix)
        self.mean_acc = np.zeros((num_mix, dim))
        self.cov_acc = np.zeros((num_mix, dim, dim))

    def accumulate(self, gmm: FullGmm, x: np.ndarray) -> float:
        x = np.asarray(x, np.float64)
        post = gmm.posteriors(x)
        self.occ += post.sum(axis=0)
        self.mean_acc += post.T @ x
        self.cov_acc += np.einsum("tm,td,te->mde", post, x, x)
        return float(gmm.loglikes(x).sum())


def mle_full_gmm_update(gmm: FullGmm, accs: AccumFullGmm,
                        min_occ: float = 10.0,
                        cov_floor: float = 1e-3) -> None:
    M, D = gmm.means.shape
    tot = accs.occ.sum()
    for m in range(M):
        if accs.occ[m] < min_occ:
            continue
        gmm.weights[m] = accs.occ[m] / max(tot, 1e-10)
        mu = accs.mean_acc[m] / accs.occ[m]
        cov = accs.cov_acc[m] / accs.occ[m] - np.outer(mu, mu)
        # floor eigenvalues
        evals, evecs = np.linalg.eigh(cov)
        evals = np.maximum(evals, cov_floor)
        gmm.means[m] = mu
        gmm.covars[m] = (evecs * evals) @ evecs.T
    gmm.weights /= gmm.weights.sum()
    gmm.refresh()
