"""i-vectors: total-variability modeling, VAD, PLDA.

Parity targets: src/ivector/ivector-extractor.h (IvectorExtractor,
OnlineIvectorEstimationStats), voice-activity-detection.h
(ComputeVadEnergy), plda.h (Plda — two-covariance PLDA scoring).

The extractor is the standard total-variability model over a diagonal
UBM:  supervector offset  m_g(w) = M_g + T_g · w ,  w ~ N(0, I).
Training is EM on Baum-Welch stats; extraction solves the posterior
precision system — both expressed as batched einsums (the per-Gaussian
loop of the reference becomes one (G, D, K) tensor contraction).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.am.gmm import AmDiagGmm

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Energy VAD
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VadEnergyOptions:
    vad_energy_threshold: float = 5.0
    vad_energy_mean_scale: float = 0.5
    vad_frames_context: int = 0
    vad_proportion_threshold: float = 0.6


def compute_vad_energy(feats: np.ndarray,
                       opts: VadEnergyOptions = VadEnergyOptions()
                       ) -> np.ndarray:
    """feats: (T, D) with C0 energy in column 0 → (T,) 0/1 decisions
    (voice-activity-detection.cc ComputeVadEnergy)."""
    log_energy = np.asarray(feats)[:, 0]
    T = len(log_energy)
    threshold = opts.vad_energy_threshold
    if opts.vad_energy_mean_scale != 0.0:
        threshold += opts.vad_energy_mean_scale * log_energy.mean()
    if opts.vad_frames_context == 0:
        return (log_energy > threshold).astype(np.float32)
    out = np.zeros(T, np.float32)
    ctx = opts.vad_frames_context
    for t in range(T):
        lo, hi = max(0, t - ctx), min(T, t + ctx + 1)
        window = log_energy[lo:hi]
        prop = (window > threshold).mean()
        out[t] = 1.0 if prop >= opts.vad_proportion_threshold else 0.0
    return out


# ---------------------------------------------------------------------------
# Total-variability i-vector extractor
# ---------------------------------------------------------------------------

class IvectorExtractor:
    """UBM (flattened single-pdf diag GMM) + T matrices (G, D, K)."""

    def __init__(self, ubm_means: np.ndarray, ubm_vars: np.ndarray,
                 ubm_weights: np.ndarray, ivector_dim: int, seed: int = 0):
        G, D = ubm_means.shape
        rng = np.random.default_rng(seed)
        self.means = ubm_means.astype(np.float64)
        self.inv_vars = 1.0 / ubm_vars.astype(np.float64)
        self.weights = ubm_weights.astype(np.float64)
        self.T = 0.1 * rng.standard_normal((G, D, ivector_dim))
        self.ivector_dim = ivector_dim

    @staticmethod
    def from_am(am: AmDiagGmm, ivector_dim: int) -> "IvectorExtractor":
        """Use a trained diag GMM ('diag UBM') as the base distribution."""
        G = am.num_pdfs * am.max_mix
        w = am.weights.reshape(G) / am.num_pdfs
        keep = w > 0
        return IvectorExtractor(am.means.reshape(G, -1)[keep],
                                am.vars.reshape(G, -1)[keep], w[keep],
                                ivector_dim)

    # -- Baum-Welch stats --------------------------------------------------
    def acc_stats(self, feats: np.ndarray,
                  weights: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """→ (gamma (G,), X (G, D)): zeroth/first-order stats under the
        UBM posteriors; optional per-frame weights (the silence-
        weighting hook — OnlineSilenceWeighting downweights frames the
        decoder aligns to silence)."""
        x = np.asarray(feats, np.float64)
        # log N(x; m_g, Σ_g) for all g: same einsum shape as GMM loglikes
        quad = (x ** 2) @ (-0.5 * self.inv_vars).T \
            + x @ (self.means * self.inv_vars).T
        gconst = (np.log(self.weights)
                  - 0.5 * (np.log(2 * np.pi / self.inv_vars).sum(1)
                           + (self.means ** 2 * self.inv_vars).sum(1)))
        logp = quad + gconst
        logp -= logp.max(axis=1, keepdims=True)
        post = np.exp(logp)
        post /= post.sum(axis=1, keepdims=True)
        if weights is not None:
            post = post * np.asarray(weights, np.float64)[:, None]
        gamma = post.sum(axis=0)
        X = post.T @ x
        return gamma, X

    # -- extraction --------------------------------------------------------
    def extract(self, gamma: np.ndarray, X: np.ndarray) -> np.ndarray:
        """MAP point estimate of w given stats."""
        K = self.ivector_dim
        TtSi = self.T * self.inv_vars[:, :, None]          # (G, D, K)
        precision = np.eye(K) + np.einsum(
            "g,gdk,gdl->kl", gamma, TtSi, self.T)
        lin = np.einsum("gdk,gd->k", TtSi, X - gamma[:, None] * self.means)
        return np.linalg.solve(precision, lin)

    def extract_from_feats(self, feats: np.ndarray) -> np.ndarray:
        return self.extract(*self.acc_stats(feats))

    # -- EM training -------------------------------------------------------
    def em_stats(self, utt_stats: Sequence[Tuple[np.ndarray, np.ndarray]]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One E-step pass over per-utterance (gamma, X) stats →
        (A (G,K,K), B (G,D,K), tot_gamma (G,)): the accumulator the
        reference's IvectorExtractorStats carries between the per-job
        acc binaries and the single est binary
        (ivectorbin/ivector-extractor-acc-stats.cc)."""
        G, D, K = self.T.shape
        A = np.zeros((G, K, K))
        B = np.zeros((G, D, K))
        tot_gamma = np.zeros(G)
        for gamma, X in utt_stats:
            TtSi = self.T * self.inv_vars[:, :, None]
            precision = np.eye(K) + np.einsum(
                "g,gdk,gdl->kl", gamma, TtSi, self.T)
            cov = np.linalg.inv(precision)
            w = cov @ np.einsum("gdk,gd->k", TtSi,
                                X - gamma[:, None] * self.means)
            Eww = cov + np.outer(w, w)
            A += gamma[:, None, None] * Eww[None]
            B += np.einsum("gd,k->gdk",
                           X - gamma[:, None] * self.means, w)
            tot_gamma += gamma
        return A, B, tot_gamma

    def em_update(self, A: np.ndarray, B: np.ndarray,
                  tot_gamma: np.ndarray) -> None:
        """M-step: per-Gaussian row solves for T
        (IvectorExtractorStats::Update)."""
        G, D, K = self.T.shape
        for g in range(G):
            if tot_gamma[g] < 1e-3:
                continue
            self.T[g] = np.linalg.solve(A[g] + 1e-8 * np.eye(K),
                                        B[g].T).T

    def train(self, utt_stats: Sequence[Tuple[np.ndarray, np.ndarray]],
              num_iters: int = 5) -> None:
        """EM over per-utterance (gamma, X) stats
        (ivector-extractor.cc IvectorExtractorStats::Update)."""
        for it in range(num_iters):
            A, B, tot_gamma = self.em_stats(utt_stats)
            self.em_update(A, B, tot_gamma)
            log.info("ivector EM iter %d: total gamma %.0f", it,
                     tot_gamma.sum())


def train_diag_ubm(feats_list, num_gauss: int = 64, num_iters: int = 4,
                   max_frames: int = 50000, seed: int = 0,
                   var_floor: float = 1e-3):
    """Flat diagonal UBM from pooled frames — the gmm-global-init-
    from-feats + gmm-global-est role (steps/online/nnet2/
    train_diag_ubm.sh) that seeds the i-vector extractor.  Returns
    (means (G, D), vars (G, D), weights (G,))."""
    X = np.concatenate([np.asarray(f, np.float64) for f in feats_list])
    rng = np.random.default_rng(seed)
    if len(X) > max_frames:
        X = X[rng.choice(len(X), max_frames, replace=False)]
    m = X[rng.choice(len(X), num_gauss, replace=False)]
    gv = X.var(axis=0) + var_floor
    v = np.tile(gv, (num_gauss, 1))
    w = np.full(num_gauss, 1.0 / num_gauss)
    for _ in range(num_iters):
        quad = (X ** 2) @ (-0.5 / v).T + X @ (m / v).T
        gconst = np.log(w) - 0.5 * (np.log(2 * np.pi * v).sum(1)
                                    + (m * m / v).sum(1))
        lp = quad + gconst
        lp -= lp.max(axis=1, keepdims=True)
        p = np.exp(lp)
        p /= p.sum(axis=1, keepdims=True)
        g = p.sum(axis=0) + 1e-8
        m = (p.T @ X) / g[:, None]
        v = np.maximum((p.T @ (X * X)) / g[:, None] - m * m, var_floor)
        w = g / g.sum()
    return m, v, w


def online_ivectors(extractor: IvectorExtractor, feats: np.ndarray,
                    period: int = 10, max_count: float = 100.0
                    ) -> np.ndarray:
    """(T, D) features → (T, K) piecewise-constant ONLINE i-vectors:
    the value at frame t is the MAP estimate from frames [0, t₀) where
    t₀ is the last period boundary ≤ t (ivector-extract-online2's
    most-recent-estimate semantics; src/online2/
    online-ivector-feature.h).  Vectorized for the egs/offline-decode
    path: UBM posteriors for all frames in one pass, stats as running
    block sums, one K×K solve per period checkpoint — the streaming
    OnlineIvectorEstimator feeds frames one at a time instead.
    ``max_count`` caps the stats mass (--max-count: bounds how far the
    estimate can move from the prior on long utterances)."""
    x = np.asarray(feats, np.float64)
    T = x.shape[0]
    K = extractor.ivector_dim
    out = np.zeros((T, K))
    if T == 0:
        return out
    # all-frames UBM posteriors (the acc_stats math, one pass)
    quad = (x ** 2) @ (-0.5 * extractor.inv_vars).T \
        + x @ (extractor.means * extractor.inv_vars).T
    gconst = (np.log(extractor.weights)
              - 0.5 * (np.log(2 * np.pi / extractor.inv_vars).sum(1)
                       + (extractor.means ** 2
                          * extractor.inv_vars).sum(1)))
    logp = quad + gconst
    logp -= logp.max(axis=1, keepdims=True)
    post = np.exp(logp)
    post /= post.sum(axis=1, keepdims=True)
    G, D = extractor.means.shape
    gamma = np.zeros(G)
    X = np.zeros((G, D))
    iv = np.zeros(K)
    for t0 in range(0, T, period):
        t1 = min(t0 + period, T)
        out[t0:t1] = iv            # estimate from frames before t0
        gamma += post[t0:t1].sum(axis=0)
        X += post[t0:t1].T @ x[t0:t1]
        g, xx = gamma, X
        if max_count > 0 and g.sum() > max_count:
            s = max_count / g.sum()
            g, xx = g * s, X * s
        iv = extractor.extract(g, xx)
    return out


class OnlineIvectorEstimator:
    """Streaming i-vector estimation: stats accumulate per chunk, the
    current estimate is available at any time
    (OnlineIvectorEstimationStats).

    Frame weights may be REVISED after the fact (the silence-weighting
    protocol: the decoder's partial traceback reclassifies earlier
    frames as silence as it advances); per-frame stats are cached so a
    weight change is a delta update, as in OnlineIvectorFeature::
    UpdateFrameWeights."""

    def __init__(self, extractor: IvectorExtractor,
                 max_count: float = 0.0):
        self.ex = extractor
        G, D = extractor.means.shape
        self.gamma = np.zeros(G)
        self.X = np.zeros((G, D))
        self.max_count = max_count
        self._frame_gamma: List[np.ndarray] = []   # per-frame (G,)
        self._frame_X: List[np.ndarray] = []       # per-frame (G, D)
        self._weights: List[float] = []

    @property
    def num_frames(self) -> int:
        return len(self._weights)

    def accept_frames(self, feats: np.ndarray,
                      weights: Optional[np.ndarray] = None) -> None:
        feats = np.atleast_2d(np.asarray(feats, np.float64))
        if weights is None:
            weights = np.ones(feats.shape[0])
        for t in range(feats.shape[0]):
            g, x = self.ex.acc_stats(feats[t:t + 1])
            self._frame_gamma.append(g)
            self._frame_X.append(x)
            self._weights.append(float(weights[t]))
            self.gamma += weights[t] * g
            self.X += weights[t] * x

    def update_frame_weights(self, weights: np.ndarray) -> None:
        """Revise weights for frames [0, len(weights)); delta-update."""
        for t, w in enumerate(weights):
            if t >= len(self._weights):
                break
            d = float(w) - self._weights[t]
            if d:
                self.gamma += d * self._frame_gamma[t]
                self.X += d * self._frame_X[t]
                self._weights[t] = float(w)

    def ivector(self) -> np.ndarray:
        gamma, X = self.gamma, self.X
        if self.max_count > 0 and gamma.sum() > self.max_count:
            scale = self.max_count / gamma.sum()
            gamma = gamma * scale
            X = X * scale
        return self.ex.extract(gamma, X)


class OnlineSilenceWeighting:
    """Frame weights from the decoder's partial traceback
    (online-ivector-feature.h OnlineSilenceWeighting): frames whose
    best-path tid maps to a silence phone get `silence_weight`, others
    1.0; undecoded frames default to 1.0."""

    def __init__(self, tm, silence_phones, silence_weight: float = 0.0):
        self.tm = tm
        self.sil = set(silence_phones)
        self.silence_weight = silence_weight

    def compute_weights(self, tid_traceback: Sequence[int],
                        num_frames: int) -> np.ndarray:
        w = np.ones(num_frames)
        for t, tid in enumerate(tid_traceback[:num_frames]):
            if self.tm.transition_id_to_phone(tid) in self.sil:
                w[t] = self.silence_weight
        return w


# ---------------------------------------------------------------------------
# PLDA
# ---------------------------------------------------------------------------

class Plda:
    """Two-covariance PLDA (plda.h): between/within class Gaussians.

    Trained from per-speaker collections of i-vectors; scoring gives the
    LLR  log P(same) − log P(different)  for a (train, test) pair.
    """

    def __init__(self, mean: np.ndarray, between: np.ndarray,
                 within: np.ndarray):
        self.mean = mean
        self.between = between
        self.within = within
        D = len(mean)
        # simultaneous diagonalization: within → I, between → diag(psi)
        w_evals, w_evecs = np.linalg.eigh(within)
        W = w_evecs @ np.diag(1.0 / np.sqrt(np.maximum(w_evals, 1e-10)))
        Bt = W.T @ between @ W
        b_evals, b_evecs = np.linalg.eigh(Bt)
        self.transform = (W @ b_evecs).T           # (D, D)
        self.psi = np.maximum(b_evals, 1e-12)

    @staticmethod
    def train(spk2ivectors: Dict[str, np.ndarray]) -> "Plda":
        all_iv = np.concatenate(list(spk2ivectors.values()))
        mean = all_iv.mean(axis=0)
        D = all_iv.shape[1]
        between = np.zeros((D, D))
        within = np.zeros((D, D))
        n_spk = 0
        for spk, ivs in spk2ivectors.items():
            m = ivs.mean(axis=0) - mean
            between += np.outer(m, m)
            c = ivs - ivs.mean(axis=0) - 0 * mean
            within += c.T @ c / max(len(ivs), 1)
            n_spk += 1
        between /= max(n_spk, 1)
        within /= max(n_spk, 1)
        within += 1e-6 * np.eye(D)
        between += 1e-6 * np.eye(D)
        return Plda(mean, between, within)

    def score(self, train_iv: np.ndarray, test_iv: np.ndarray,
              n_train: int = 1) -> float:
        """LLR same-vs-different speaker (plda.cc LogLikelihoodRatio)."""
        u = self.transform @ (np.asarray(train_iv) - self.mean)
        v = self.transform @ (np.asarray(test_iv) - self.mean)
        n = n_train
        psi = self.psi
        # given class mean distribution for same-speaker hypothesis
        mean_same = (n * psi / (n * psi + 1.0)) * u
        var_same = 1.0 + psi / (n * psi + 1.0)
        var_diff = 1.0 + psi
        ll_same = -0.5 * (np.log(2 * np.pi * var_same)
                          + (v - mean_same) ** 2 / var_same).sum()
        ll_diff = -0.5 * (np.log(2 * np.pi * var_diff)
                          + v ** 2 / var_diff).sum()
        return float(ll_same - ll_diff)


# ---------------------------------------------------------------------------
# Agglomerative clustering (speaker diarization)
# ---------------------------------------------------------------------------

def agglomerative_cluster(scores: np.ndarray, threshold: float,
                          min_clusters: int = 1,
                          max_clusters: Optional[int] = None) -> np.ndarray:
    """Average-linkage agglomerative clustering over a pairwise
    similarity matrix (higher = more similar).

    The src/ivector/agglomerative-clustering.h role: each segment starts
    as its own cluster; the most-similar cluster pair merges while its
    linkage score exceeds `threshold` (or while more than `max_clusters`
    remain, which forces merges below threshold).  Stops at
    `min_clusters`.  Returns int labels (0..C-1) in first-appearance
    order — the ivectorbin/agglomerative-cluster.cc contract with
    spk2utt output.
    """
    scores = np.asarray(scores, np.float64)
    N = scores.shape[0]
    if N == 0:
        return np.zeros(0, np.int32)
    clusters: Dict[int, List[int]] = {i: [i] for i in range(N)}
    # linkage[a,b] = mean pairwise score between members of a and b
    while len(clusters) > max(min_clusters, 1):
        keys = sorted(clusters)
        best, pair = -np.inf, None
        for ai in range(len(keys)):
            for bi in range(ai + 1, len(keys)):
                a, b = keys[ai], keys[bi]
                s = float(np.mean(scores[np.ix_(clusters[a], clusters[b])]))
                if s > best:
                    best, pair = s, (a, b)
        forced = max_clusters is not None and len(clusters) > max_clusters
        if pair is None or (best <= threshold and not forced):
            break
        a, b = pair
        clusters[a] = clusters[a] + clusters[b]
        del clusters[b]
    labels = np.full(N, -1, np.int32)
    next_id = 0
    order = sorted(clusters.values(), key=min)
    for members in order:
        for m in members:
            labels[m] = next_id
        next_id += 1
    return labels


def plda_score_matrix(plda: "Plda", ivectors: np.ndarray) -> np.ndarray:
    """Symmetric pairwise PLDA LLR matrix for diarization."""
    ivectors = np.asarray(ivectors)
    N = len(ivectors)
    S = np.zeros((N, N))
    for i in range(N):
        for j in range(i + 1, N):
            s = 0.5 * (plda.score(ivectors[i], ivectors[j])
                       + plda.score(ivectors[j], ivectors[i]))
            S[i, j] = S[j, i] = s
    return S


def diarize(plda: "Plda", segment_ivectors: np.ndarray, threshold: float = 0.0,
            min_clusters: int = 1,
            max_clusters: Optional[int] = None) -> np.ndarray:
    """Cluster per-segment i-vectors into speaker labels (the
    egs/callhome_diarization pipeline role: PLDA scoring +
    agglomerative-cluster)."""
    S = plda_score_matrix(plda, segment_ivectors)
    return agglomerative_cluster(S, threshold, min_clusters=min_clusters,
                                 max_clusters=max_clusters)


# ---------------------------------------------------------------------------
# Serialization (ivector-extractor / plda files)
# ---------------------------------------------------------------------------

def write_ivector_extractor(path: str, ex: IvectorExtractor) -> None:
    """Kaldi-style token-framed binary (the IvectorExtractor Write role;
    layout is this build's own — byte-compat unverifiable, SURVEY §0)."""
    from kaldi_tpu.core.io import write_matrix, write_token, write_vector
    G, D, K = ex.T.shape
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_token(f, "<IvectorExtractor>")
        write_matrix(f, ex.means.astype(np.float64), dtype="float64")
        write_matrix(f, (1.0 / ex.inv_vars).astype(np.float64),
                     dtype="float64")
        write_vector(f, ex.weights.astype(np.float64), dtype="float64")
        write_matrix(f, ex.T.reshape(G, D * K).astype(np.float64),
                     dtype="float64")
        write_vector(f, np.array([K], np.float64), dtype="float64")
        write_token(f, "</IvectorExtractor>")


def read_ivector_extractor(path: str) -> IvectorExtractor:
    from kaldi_tpu.core.io import (expect_token, read_matrix, read_token,
                                   read_vector)
    from kaldi_tpu.core.logging import KaldiError
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not binary kaldi")
        expect_token(f, "<IvectorExtractor>")
        means = read_matrix(f)
        variances = read_matrix(f)
        weights = read_vector(f)
        Tflat = read_matrix(f)
        K = int(read_vector(f)[0])
        expect_token(f, "</IvectorExtractor>")
    G, D = means.shape
    ex = IvectorExtractor(means, variances, weights, K)
    ex.T = Tflat.reshape(G, D, K).astype(np.float64)
    return ex


def write_plda(path: str, plda: "Plda") -> None:
    from kaldi_tpu.core.io import write_matrix, write_token, write_vector
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_token(f, "<Plda>")
        write_vector(f, plda.mean.astype(np.float64), dtype="float64")
        write_matrix(f, plda.between.astype(np.float64), dtype="float64")
        write_matrix(f, plda.within.astype(np.float64), dtype="float64")
        write_token(f, "</Plda>")


def read_plda(path: str) -> "Plda":
    from kaldi_tpu.core.io import (expect_token, read_matrix, read_token,
                                   read_vector)
    from kaldi_tpu.core.logging import KaldiError
    with open(path, "rb") as f:
        if f.read(2) != b"\0B":
            raise KaldiError(f"{path}: not binary kaldi")
        expect_token(f, "<Plda>")
        mean = read_vector(f)
        between = read_matrix(f)
        within = read_matrix(f)
        expect_token(f, "</Plda>")
    return Plda(mean.astype(np.float64), between.astype(np.float64),
                within.astype(np.float64))
