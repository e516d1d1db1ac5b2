"""Diagonal-covariance GMM acoustic models.

Parity targets: src/gmm/diag-gmm.h (DiagGmm), am-diag-gmm.h (AmDiagGmm),
mle-diag-gmm.h (AccumDiagGmm, MleDiagGmmUpdate), and the flat-start /
mixing-up flow of gmm-init-mono / gmm-mixup.

Design: the whole acoustic model is three dense tensors
padded to a common number of mixture components

    gconsts        (P, M)     log w − ½(D·log2π + Σ log σ² + Σ μ²/σ²)
    means_invvars  (P, M, D)  μ/σ²
    inv_vars       (P, M, D)  1/σ²

so per-utterance log-likelihoods for ALL pdfs are two matmuls plus a
logsumexp — `loglikes = x²·(−½/σ²) + x·(μ/σ²) + gconst` — an matmul-shaped
einsum, replacing the reference's per-(frame,pdf) virtual
DecodableAmDiagGmmScaled::LogLikelihood calls (the HOT spot of §3.3).
Unused mixture slots carry gconst = −inf and vanish in the logsumexp.

Sufficient-statistic accumulation (occupancy, Σγx, Σγx²) is on-device
as segment-sums over frames; stats add across shards with psum exactly
like gmm-sum-accs adds accumulator files.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)

_NEG_INF = -1.0e30
_LOG_2PI = math.log(2.0 * math.pi)


class AmDiagGmm:
    """All pdfs' GMMs as padded (P, M, D) tensors (numpy host copy;
    jnp views created on demand for the jitted loglike path)."""

    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 variances: np.ndarray):
        """weights (P, M) with zero rows padding; means/vars (P, M, D)."""
        self.weights = weights.astype(np.float64)
        self.means = means.astype(np.float64)
        self.vars = variances.astype(np.float64)
        self._device = None

    # ------------------------------------------------------------------
    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_mix(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    def num_gauss(self) -> int:
        return int((self.weights > 0).sum())

    # ------------------------------------------------------------------
    @staticmethod
    def flat_start(num_pdfs: int, glob_mean: np.ndarray, glob_var: np.ndarray,
                   perturb: float = 0.0, seed: int = 0) -> "AmDiagGmm":
        """gmm-init-mono: every pdf = 1 Gaussian at the global mean/var,
        optionally perturbed so pdfs are not identical."""
        D = len(glob_mean)
        rng = np.random.default_rng(seed)
        means = np.tile(glob_mean, (num_pdfs, 1, 1))
        if perturb > 0:
            means = means + perturb * np.sqrt(glob_var) * rng.standard_normal(
                (num_pdfs, 1, D))
        variances = np.tile(glob_var, (num_pdfs, 1, 1))
        weights = np.ones((num_pdfs, 1))
        return AmDiagGmm(weights, means, variances)

    # ------------------------------------------------------------------
    def _natural_params(self):
        w = self.weights
        valid = w > 0
        safe_var = np.where(valid[..., None], self.vars, 1.0)
        inv_var = 1.0 / safe_var
        mean_invvar = self.means * inv_var
        gconst = np.where(
            valid,
            np.log(np.maximum(w, 1e-300))
            - 0.5 * (self.dim * _LOG_2PI
                     + np.log(safe_var).sum(-1)
                     + (self.means * mean_invvar).sum(-1)),
            _NEG_INF)
        return (gconst.astype(np.float32),
                mean_invvar.astype(np.float32),
                inv_var.astype(np.float32))

    def refresh(self) -> None:
        """Invalidate device constants after a parameter update."""
        self._device = None

    def device_params(self):
        if self._device is None:
            gconst, mean_invvar, inv_var = self._natural_params()
            self._device = (jnp.asarray(gconst),
                            jnp.asarray(mean_invvar),
                            jnp.asarray(inv_var))
        return self._device

    # ------------------------------------------------------------------
    def loglikes(self, feats) -> jnp.ndarray:
        """(T, D) features → (T, P) per-pdf log-likelihoods (jitted).
        T is padded to a 64-frame bucket so arbitrary lengths share
        compilations; the pad is sliced off."""
        gconst, mean_invvar, inv_var = self.device_params()
        feats = np.asarray(feats, np.float32)
        T = feats.shape[0]
        T_pad = ((T + 63) // 64) * 64
        if T_pad != T:
            feats = np.concatenate(
                [feats, np.zeros((T_pad - T, feats.shape[1]), np.float32)])
        out = _loglikes_jit(jnp.asarray(feats), gconst, mean_invvar, inv_var)
        return out[:T]

    def component_posteriors(self, feats, pdfs) -> jnp.ndarray:
        """Mixture posteriors γ (T, M) for each frame's aligned pdf.
        Bucketed to 64-frame multiples like loglikes."""
        gconst, mean_invvar, inv_var = self.device_params()
        feats = np.asarray(feats, np.float32)
        pdfs = np.asarray(pdfs, np.int32)
        T = feats.shape[0]
        T_pad = ((T + 63) // 64) * 64
        if T_pad != T:
            feats = np.concatenate(
                [feats, np.zeros((T_pad - T, feats.shape[1]), np.float32)])
            pdfs = np.concatenate([pdfs, np.zeros(T_pad - T, np.int32)])
        out = _component_post_jit(jnp.asarray(feats), jnp.asarray(pdfs),
                                  gconst, mean_invvar, inv_var)
        return out[:T]


@jax.jit
def _loglikes_jit(x, gconst, mean_invvar, inv_var):
    # x: (T, D); gconst: (P, M); mean_invvar/inv_var: (P, M, D)
    P, M, D = mean_invvar.shape
    a = mean_invvar.reshape(P * M, D)
    b = (-0.5 * inv_var).reshape(P * M, D)
    quad = x @ a.T + (x * x) @ b.T                  # (T, P*M) — matmuls
    comp = quad.reshape(-1, P, M) + gconst[None]
    return jax.scipy.special.logsumexp(comp, axis=2)


@jax.jit
def _component_post_jit(x, pdfs, gconst, mean_invvar, inv_var):
    # gather per-frame pdf params then per-component loglikes → softmax
    mi = mean_invvar[pdfs]                          # (T, M, D)
    iv = inv_var[pdfs]
    gc = gconst[pdfs]                               # (T, M)
    comp = (gc + jnp.einsum("td,tmd->tm", x, mi)
            - 0.5 * jnp.einsum("td,tmd->tm", x * x, iv))
    return jax.nn.softmax(comp, axis=1)


# ---------------------------------------------------------------------------
# Training: accumulators + MLE update (mle-diag-gmm.h semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GmmAccs:
    """Per-pdf sufficient stats; add with '+' (gmm-sum-accs)."""
    occ: np.ndarray        # (P, M)
    mean_acc: np.ndarray   # (P, M, D)
    var_acc: np.ndarray    # (P, M, D)
    tot_like: float = 0.0
    tot_frames: float = 0.0

    @staticmethod
    def zeros(num_pdfs: int, max_mix: int, dim: int) -> "GmmAccs":
        return GmmAccs(np.zeros((num_pdfs, max_mix)),
                       np.zeros((num_pdfs, max_mix, dim)),
                       np.zeros((num_pdfs, max_mix, dim)))

    def __add__(self, other: "GmmAccs") -> "GmmAccs":
        return GmmAccs(self.occ + other.occ,
                       self.mean_acc + other.mean_acc,
                       self.var_acc + other.var_acc,
                       self.tot_like + other.tot_like,
                       self.tot_frames + other.tot_frames)


@partial(jax.jit, static_argnums=(5,))
def _acc_stats_jit(x, pdfs, gconst, mean_invvar, inv_var, num_pdfs):
    post = _component_post_jit(x, pdfs, gconst, mean_invvar, inv_var)  # (T,M)
    occ = jax.ops.segment_sum(post, pdfs, num_segments=num_pdfs)
    mean_acc = jax.ops.segment_sum(post[:, :, None] * x[:, None, :], pdfs,
                                   num_segments=num_pdfs)
    var_acc = jax.ops.segment_sum(post[:, :, None] * (x * x)[:, None, :],
                                  pdfs, num_segments=num_pdfs)
    # total loglike of the aligned pdfs
    gc = gconst[pdfs]
    comp = (gc + jnp.einsum("td,tmd->tm", x, mean_invvar[pdfs])
            - 0.5 * jnp.einsum("td,tmd->tm", x * x, inv_var[pdfs]))
    tot = jnp.sum(jax.scipy.special.logsumexp(comp, axis=1))
    return occ, mean_acc, var_acc, tot


def accumulate_stats(am: AmDiagGmm, feats: np.ndarray, pdf_ali: np.ndarray,
                     accs: GmmAccs) -> float:
    """gmm-acc-stats-ali: Viterbi accumulation from a pdf alignment.
    Returns the total log-likelihood of the utterance."""
    gconst, mean_invvar, inv_var = am.device_params()
    occ, mean_acc, var_acc, tot = _acc_stats_jit(
        jnp.asarray(feats, jnp.float32), jnp.asarray(pdf_ali, jnp.int32),
        gconst, mean_invvar, inv_var, am.num_pdfs)
    accs.occ += np.asarray(occ, dtype=np.float64)
    accs.mean_acc += np.asarray(mean_acc, dtype=np.float64)
    accs.var_acc += np.asarray(var_acc, dtype=np.float64)
    accs.tot_like += float(tot)
    accs.tot_frames += len(pdf_ali)
    return float(tot)


def accumulate_stats_twofeats(am: AmDiagGmm, feats_post: np.ndarray,
                              feats_stats: np.ndarray,
                              pdf_ali: np.ndarray,
                              accs: GmmAccs) -> None:
    """gmm-acc-stats-twofeats: component POSTERIORS computed on one
    feature stream (the adapted/SAT features the model was trained
    on), Gaussian STATS accumulated on another (the unadapted
    features).  One gmm-est pass over these stats yields the SAT
    'alimdl' — the model the first, transform-less decoding pass uses
    (steps/train_sat.sh final stage; steps/decode_fmllr.sh reads
    final.alimdl)."""
    post = np.asarray(am.component_posteriors(feats_post, pdf_ali),
                      np.float64)
    x = np.asarray(feats_stats, np.float64)
    pdfs = np.asarray(pdf_ali, np.int64)
    np.add.at(accs.occ, pdfs, post)
    np.add.at(accs.mean_acc, pdfs, post[:, :, None] * x[:, None, :])
    np.add.at(accs.var_acc, pdfs, post[:, :, None] * (x * x)[:, None, :])
    accs.tot_frames += len(pdfs)


def mle_update(am: AmDiagGmm, accs: GmmAccs,
               min_occ: float = 3.0, var_floor: float = 1e-3,
               remove_low_count: bool = True) -> None:
    """gmm-est (MleDiagGmmUpdate): re-estimate weights/means/vars in
    place; components below min_occ keep their old parameters (or are
    dropped by zeroing their weight when others exist)."""
    occ = accs.occ
    valid_model = am.weights > 0
    update = (occ > min_occ) & valid_model
    tot_occ = occ.sum(axis=1, keepdims=True)

    new_w = np.where(valid_model, occ / np.maximum(tot_occ, 1e-10), 0.0)
    # pdfs with no data at all keep old weights
    has_data = tot_occ[:, 0] > min_occ
    am.weights = np.where(has_data[:, None], new_w, am.weights)

    safe_occ = np.maximum(occ, 1e-10)[..., None]
    new_mean = accs.mean_acc / safe_occ
    new_var = np.maximum(accs.var_acc / safe_occ - new_mean ** 2, var_floor)
    am.means = np.where(update[..., None], new_mean, am.means)
    am.vars = np.where(update[..., None], new_var, am.vars)

    if remove_low_count:
        dead = valid_model & ~update & has_data[:, None] \
            & (am.weights < 1e-8)
        if dead.any():
            am.weights = np.where(dead, 0.0, am.weights)
    # renormalize
    wsum = am.weights.sum(axis=1, keepdims=True)
    am.weights = am.weights / np.maximum(wsum, 1e-10)
    am.refresh()
    if accs.tot_frames > 0:
        log.info("mle_update: avg loglike/frame %.4f over %.0f frames",
                 accs.tot_like / accs.tot_frames, accs.tot_frames)


def map_update(am: AmDiagGmm, accs: GmmAccs, mean_tau: float = 10.0,
               weight_tau: float = 0.0, var_tau: float = 0.0,
               var_floor: float = 1e-3) -> None:
    """gmm-adapt-map (MapDiagGmmUpdate, mle-diag-gmm.h): MAP
    re-estimation interpolating new statistics with the prior (current)
    parameters, per Gauvain & Lee:

        μ' = (γ·x̄ + τ·μ₀) / (γ + τ)

    and analogously for weights/variances when their τ > 0.  τ = 0
    disables that parameter's update entirely for weights/vars (the
    reference's --weight-tau / --var-tau default behaviour is
    means-only adaptation, used for per-speaker / per-domain adapted
    models)."""
    occ = accs.occ                                     # (P, M)
    safe = np.maximum(occ, 1e-10)[..., None]
    xbar = accs.mean_acc / safe
    valid = (am.weights > 0) & (occ > 0)
    new_mean = (occ[..., None] * xbar + mean_tau * am.means) \
        / (occ[..., None] + mean_tau)
    am.means = np.where(valid[..., None], new_mean, am.means)
    if var_tau > 0:
        ex2 = accs.var_acc / safe
        sample_var = np.maximum(ex2 - xbar ** 2, var_floor)
        new_var = (occ[..., None] * sample_var + var_tau * am.vars) \
            / (occ[..., None] + var_tau)
        am.vars = np.where(valid[..., None],
                           np.maximum(new_var, var_floor), am.vars)
    if weight_tau > 0:
        tot = occ.sum(axis=1, keepdims=True)
        ml_w = occ / np.maximum(tot, 1e-10)
        new_w = (tot * ml_w + weight_tau * am.weights) \
            / (tot + weight_tau)
        has = tot[:, 0] > 0
        am.weights = np.where(has[:, None], new_w, am.weights)
        am.weights /= np.maximum(am.weights.sum(axis=1, keepdims=True),
                                 1e-10)
    am.refresh()
    if accs.tot_frames > 0:
        log.info("map_update: tau=%.1f, avg loglike/frame %.4f over "
                 "%.0f frames", mean_tau,
                 accs.tot_like / accs.tot_frames, accs.tot_frames)


def mixup(am: AmDiagGmm, target_tot_gauss: int, perturb: float = 0.01,
          seed: int = 0) -> AmDiagGmm:
    """gmm-mixup: split heaviest components (weighted by pdf occupancy
    share) until the model has target_tot_gauss Gaussians."""
    rng = np.random.default_rng(seed)
    P, M, D = am.means.shape
    cur = am.num_gauss()
    n_new = target_tot_gauss - cur
    if n_new <= 0:
        return am
    # candidate: (weight, pdf, mix) — split globally largest weights
    grow = max(M, int(np.ceil((cur + n_new) / P)))
    weights = np.zeros((P, grow))
    means = np.zeros((P, grow, D))
    variances = np.ones((P, grow, D))
    weights[:, :M] = am.weights
    means[:, :M] = am.means
    variances[:, :M] = am.vars
    next_slot = (am.weights > 0).sum(axis=1).astype(int)
    flat = [(-weights[p, m], p, m) for p in range(P) for m in range(M)
            if weights[p, m] > 0]
    import heapq
    heapq.heapify(flat)
    for _ in range(n_new):
        while True:
            negw, p, m = heapq.heappop(flat)
            if next_slot[p] < grow:
                break
        s = next_slot[p]
        next_slot[p] += 1
        w = -negw / 2.0
        weights[p, m] = w
        weights[p, s] = w
        offset = perturb * np.sqrt(variances[p, m]) * rng.standard_normal(D)
        means[p, s] = means[p, m] + offset
        means[p, m] = means[p, m] - offset
        variances[p, s] = variances[p, m]
        heapq.heappush(flat, (-w, p, m))
        heapq.heappush(flat, (-w, p, s))
    out = AmDiagGmm(weights, means, variances)
    log.info("mixup: %d → %d gaussians (max-mix %d)", cur,
             out.num_gauss(), grow)
    return out


def global_stats(feats_iter) -> Tuple[np.ndarray, np.ndarray]:
    """Global mean/var over an iterable of (T, D) matrices (flat start)."""
    n, s, ss = 0.0, None, None
    for m in feats_iter:
        m = np.asarray(m, dtype=np.float64)
        if s is None:
            s = m.sum(0)
            ss = (m ** 2).sum(0)
        else:
            s += m.sum(0)
            ss += (m ** 2).sum(0)
        n += m.shape[0]
    mean = s / n
    var = np.maximum(ss / n - mean ** 2, 1e-6)
    return mean, var
