"""Subspace GMM acoustic model (SGMM2) with substates and a speaker
subspace.

Parity target: src/sgmm2/ (AmSgmm2, am-sgmm2.h; Povey et al. 2011,
"The subspace Gaussian mixture model").  The model shares a UBM-sized
set of I Gaussians across ALL tied states; state j owns K_j substate
vectors v_jk ∈ R^S with substate weights c_jk, from which per-Gaussian
means and mixture weights expand; a speaker subspace N_i shifts every
mean by a per-speaker offset:

    μ_jki^(s) = M_i v_jk + N_i u_s    (M_i ∈ R^{D×S}, N_i ∈ R^{D×U})
    w_jki = softmax_i(w_i·v_jk)       (w_i ∈ R^S, shared)
    p(x|j,s) = Σ_k c_jk Σ_i w_jki N(x; μ_jki^(s), Σ_i)

Shape: everything is batched einsums —
- all substate means at once: μ = einsum('ids,jks->jkid', M, V)
- per-frame loglikes over ALL (j, k, i): one quadratic-expansion
  contraction + logsumexp, like the diag-GMM path (am/gmm.py); the
  speaker offset folds in as per-Gaussian shifted inputs x − N_i u_s.
- EM statistics: posterior-weighted einsums accumulated on device.

Covariances: diagonal Σ_i by default (var, (I, D)); FULL covariances
(Sigma, (I, D, D)) are supported throughout — loglikes, EM stats, the
M-step (the v/H solves use the full precision; the M_i/N_i least
squares are covariance-independent), the Σ_i update with eigenvalue
flooring, speaker vectors, and serialization — matching am-sgmm2.h's
full-covariance contract.  The weight vectors w_i are updated by
REPEATED safeguarded quadratic-bound steps (auxf-checked halving, the
MleAmSgmm2Updater weight-iteration loop), not a single step.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class Sgmm2:
    """Parameters.  J states, K max substates, I shared Gaussians,
    D feats, S phonetic subspace, U speaker subspace (0 = none).
    Padded substates carry c == 0 and are masked everywhere."""
    M: np.ndarray          # (I, D, S) phonetic-subspace projections
    w: np.ndarray          # (I, S) weight projections
    var: np.ndarray        # (I, D) shared diagonal covariances
    V: np.ndarray          # (J, K, S) substate vectors
    c: np.ndarray          # (J, K) substate weights (rows sum to 1)
    N: Optional[np.ndarray] = None    # (I, D, U) speaker subspace
    Sigma: Optional[np.ndarray] = None  # (I, D, D) FULL covariances;
    #                                     when set, overrides `var`
    #                                     (whose diagonal is kept in
    #                                     sync for metric helpers)

    def precision(self) -> Tuple[np.ndarray, np.ndarray]:
        """(Σ_i⁻¹ (I, D, D), log|Σ_i| (I,)) — full-covariance helpers
        (diagonal models get the equivalent diag embedding)."""
        if self.Sigma is not None:
            P = np.linalg.inv(self.Sigma)
            _sign, logdet = np.linalg.slogdet(self.Sigma)
            return P, logdet
        D = self.dim
        P = np.zeros((self.M.shape[0], D, D))
        P[:, np.arange(D), np.arange(D)] = 1.0 / self.var
        return P, np.sum(np.log(self.var), axis=1)

    @property
    def num_pdfs(self) -> int:
        return self.V.shape[0]

    @property
    def num_substates(self) -> int:
        return self.V.shape[1]

    @property
    def dim(self) -> int:
        return self.M.shape[1]

    @property
    def spk_dim(self) -> int:
        return 0 if self.N is None else self.N.shape[2]

    # -- expansion ---------------------------------------------------------
    def means(self) -> np.ndarray:
        """(J, K, I, D) expanded substate means (speaker-independent)."""
        return np.einsum("ids,jks->jkid", self.M, self.V)

    def log_weights(self) -> np.ndarray:
        """(J, K, I) log w_jki (per-substate Gaussian weights)."""
        logits = np.einsum("jks,is->jki", self.V, self.w)
        return np.asarray(
            logits - jax.nn.logsumexp(jnp.asarray(logits), axis=2,
                                      keepdims=True))

    def spk_offset(self, u: np.ndarray) -> np.ndarray:
        """(I, D) per-Gaussian mean offsets N_i u_s."""
        if self.N is None:
            raise KaldiError("model has no speaker subspace")
        return np.einsum("idu,u->id", self.N, np.asarray(u))

    def loglikes(self, feats: np.ndarray,
                 spk_u: Optional[np.ndarray] = None) -> jnp.ndarray:
        """(T, D) → (T, J) log p(x_t | j): quadratic expansion keeps it
        batched matmuls + logsumexp (matmul-shaped).  ``spk_u`` applies
        the speaker subspace by shifting each Gaussian's input."""
        x = jnp.asarray(feats, jnp.float32)            # (T, D)
        mu = jnp.asarray(self.means(), jnp.float32)    # (J, K, I, D)
        logw = jnp.asarray(self.log_weights(), jnp.float32)
        logc = jnp.asarray(
            np.log(np.maximum(self.c, 1e-30)), jnp.float32)  # (J, K)
        if self.Sigma is not None:
            P_np, logdet_np = self.precision()
        else:                       # diag: no dense (I, D, D) build
            logdet_np = np.sum(np.log(self.var), axis=1)
        gconst = jnp.asarray(
            -0.5 * (self.dim * np.log(2 * np.pi) + logdet_np),
            jnp.float32)                               # (I,)
        if spk_u is not None and self.N is not None:
            off = jnp.asarray(self.spk_offset(spk_u), jnp.float32)
            xi = x[:, None, :] - off[None]             # (T, I, D)
        else:
            xi = jnp.broadcast_to(x[:, None, :],
                                  (x.shape[0], self.M.shape[0],
                                   self.dim))          # (T, I, D)
        if self.Sigma is not None:
            P = jnp.asarray(P_np, jnp.float32)         # (I, D, D)
            xP = jnp.einsum("tid,ide->tie", xi, P)     # (T, I, D)
            xq = -0.5 * jnp.sum(xP * xi, axis=2)       # (T, I)
            xl = jnp.einsum("tie,jkie->tjki", xP, mu)
            muP = jnp.einsum("jkid,ide->jkie", mu, P)
            mq = -0.5 * jnp.sum(muP * mu, axis=3)      # (J, K, I)
        else:
            inv = 1.0 / jnp.asarray(self.var, jnp.float32)
            xq = -0.5 * jnp.sum(xi * xi * inv[None], axis=2)
            xl = jnp.einsum("tid,jkid->tjki", xi * inv[None], mu)
            mq = -0.5 * jnp.sum(mu * mu * inv[None, None], axis=3)
        comp = (xq[:, None, None, :] + xl + mq[None]
                + gconst[None, None, None] + logw[None]
                + logc[None, :, :, None])              # (T, J, K, I)
        return jax.nn.logsumexp(comp, axis=(2, 3))


@dataclasses.dataclass
class Sgmm2Accs:
    """EM sufficient statistics (MleAmSgmm2Accs role).  ``y`` keeps
    speaker offsets REMOVED (x − N_i u_s), so the phonetic updates see
    speaker-normalized data; ``Z`` keeps state means removed, for the
    speaker-subspace update."""
    gamma: np.ndarray      # (J, K, I) posterior mass
    y: np.ndarray          # (J, K, I, D) Σ γ·(x − N u)
    S: np.ndarray          # (I, D) Σ γ·(x − N u)²
    Z: Optional[np.ndarray] = None   # (I, D, U) Σ γ·(x − M v) uᵀ
    R: Optional[np.ndarray] = None   # (I, U, U) Σ γ·u uᵀ
    S2: Optional[np.ndarray] = None  # (I, D, D) full scatter
    #                                  Σ γ·(x − N u)(x − N u)ᵀ —
    #                                  accumulated for full-cov models
    tot_like: float = 0.0
    tot_frames: float = 0.0

    def __add__(self, o: "Sgmm2Accs") -> "Sgmm2Accs":
        if (self.S2 is None) != (o.S2 is None):
            raise KaldiError("Sgmm2Accs: cannot sum full-covariance "
                             "scatter stats with diagonal-only stats "
                             "(one side lacks S2 — re-accumulate all "
                             "jobs against the same model)")
        return Sgmm2Accs(
            gamma=self.gamma + o.gamma, y=self.y + o.y, S=self.S + o.S,
            Z=None if self.Z is None else self.Z + o.Z,
            R=None if self.R is None else self.R + o.R,
            S2=None if self.S2 is None else self.S2 + o.S2,
            tot_like=self.tot_like + o.tot_like,
            tot_frames=self.tot_frames + o.tot_frames)


def init_sgmm(num_pdfs: int, dim: int, num_gauss: int, subspace: int,
              glob_mean: np.ndarray, glob_var: np.ndarray,
              spk_subspace: int = 0, seed: int = 0,
              full_cov: bool = False) -> Sgmm2:
    """sgmm2-init role: M_i's first column carries a perturbed global
    mean (so v = e1 reproduces a flat start), the rest small noise;
    v_j0 = e1 + noise so states start near the global model; one
    substate per state (split later with split_substates)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((num_gauss, dim, subspace)).astype(
        np.float64) * 0.1
    M[:, :, 0] = glob_mean[None] + rng.standard_normal(
        (num_gauss, dim)) * np.sqrt(glob_var)[None]
    w = rng.standard_normal((num_gauss, subspace)) * 0.1
    V = np.zeros((num_pdfs, 1, subspace))
    V[:, 0, 0] = 1.0
    V += rng.standard_normal(V.shape) * 0.01
    c = np.ones((num_pdfs, 1))
    var = np.tile(glob_var[None], (num_gauss, 1))
    N = (rng.standard_normal((num_gauss, dim, spk_subspace)) * 0.1
         if spk_subspace else None)
    Sigma = None
    if full_cov:
        Sigma = np.zeros((num_gauss, dim, dim))
        Sigma[:, np.arange(dim), np.arange(dim)] = var
    return Sgmm2(M=M, w=w, var=var, V=V, c=c, N=N, Sigma=Sigma)


def _frame_posteriors(model: Sgmm2, x: jnp.ndarray, j: jnp.ndarray,
                      spk_u: Optional[np.ndarray]):
    """(T, K, I) posteriors over (substate, Gaussian) of the aligned
    state, plus per-frame loglikes and the shifted inputs."""
    mu = jnp.asarray(model.means(), jnp.float32)[j]     # (T, K, I, D)
    logw = jnp.asarray(model.log_weights(), jnp.float32)[j]
    logc = jnp.asarray(np.log(np.maximum(model.c, 1e-30)),
                       jnp.float32)[j]                  # (T, K)
    if model.Sigma is not None:
        P_np, logdet_np = model.precision()
    else:                           # diag: no dense (I, D, D) build
        logdet_np = np.sum(np.log(model.var), axis=1)
    gconst = jnp.asarray(
        -0.5 * (model.dim * np.log(2 * np.pi) + logdet_np),
        jnp.float32)
    if spk_u is not None and model.N is not None:
        off = jnp.asarray(model.spk_offset(spk_u), jnp.float32)
        xi = x[:, None, :] - off[None]                  # (T, I, D)
    else:
        xi = jnp.tile(x[:, None, :], (1, model.M.shape[0], 1))
    diff = xi[:, None, :, :] - mu                       # (T, K, I, D)
    if model.Sigma is not None:
        P = jnp.asarray(P_np, jnp.float32)
        q = jnp.einsum("tkid,ide,tkie->tki", diff, P, diff)
        logn = gconst[None, None] - 0.5 * q             # (T, K, I)
    else:
        inv = 1.0 / jnp.asarray(model.var, jnp.float32)
        logn = gconst[None, None] - 0.5 * jnp.sum(
            diff * diff * inv[None, None], axis=3)      # (T, K, I)
    comp = logn + logw + logc[:, :, None]
    norm = jax.nn.logsumexp(comp, axis=(1, 2), keepdims=True)
    post = jnp.exp(comp - norm)                         # (T, K, I)
    return post, norm[:, 0, 0], xi


def accumulate(model: Sgmm2, feats: np.ndarray, pdf_ali: np.ndarray,
               spk_u: Optional[np.ndarray] = None) -> Sgmm2Accs:
    """E-step with fixed state alignments (gmm-acc-stats-ali shape):
    per frame t aligned to state j_t, posteriors over (k, i)."""
    x = jnp.asarray(feats, jnp.float32)
    j = jnp.asarray(pdf_ali, jnp.int32)
    post, norms, xi = _frame_posteriors(model, x, j, spk_u)
    J = model.num_pdfs
    gamma = jax.ops.segment_sum(post, j, num_segments=J)   # (J, K, I)
    y = jax.ops.segment_sum(
        post[:, :, :, None] * xi[:, None, :, :], j,
        num_segments=J)                                 # (J, K, I, D)
    S = jnp.einsum("tki,tid->id", post, xi * xi)        # (I, D)
    S2 = None
    if model.Sigma is not None:
        gi_t = jnp.sum(post, axis=1)                    # (T, I)
        S2 = np.asarray(jnp.einsum("ti,tid,tie->ide", gi_t, xi, xi),
                        np.float64)
    Z = R = None
    if spk_u is not None and model.N is not None:
        # speaker-subspace stats: the utterance shares one u, so
        #   Z_i = [Σ_t γ_i(t) (x_t − M v)] uᵀ,  R_i = [Σ_t γ_i(t)] u uᵀ
        u = np.asarray(spk_u, np.float64)
        mu = jnp.asarray(model.means(), jnp.float32)[j]
        gi = np.asarray(jnp.sum(post, axis=(0, 1)), np.float64)  # (I,)
        resid = np.asarray(jnp.einsum(
            "tki,tkid->id", post, x[:, None, None, :] - mu),
            np.float64)                                 # (I, D)
        Z = np.einsum("id,u->idu", resid, u)
        R = np.einsum("i,u,v->iuv", gi, u, u)
    return Sgmm2Accs(gamma=np.asarray(gamma, np.float64),
                     y=np.asarray(y, np.float64),
                     S=np.asarray(S, np.float64), Z=Z, R=R, S2=S2,
                     tot_like=float(jnp.sum(norms)),
                     tot_frames=float(x.shape[0]))


def update(model: Sgmm2, accs: Sgmm2Accs, min_var: float = 1e-3,
           w_step: float = 1.0, w_iters: int = 3,
           update_spk: bool = True) -> Sgmm2:
    """M-step (MleAmSgmm2Updater role).  Order as in the reference:
    v, then M, then (N), then w, then c, then Σ.  Full-covariance
    models (model.Sigma set) use the full precision in the v solves
    and update Σ_i from the full scatter; the M_i/N_i least squares
    are covariance-independent (the Σ⁻¹ factors out of their normal
    equations)."""
    J, K = model.V.shape[:2]
    I, D = model.M.shape[0], model.dim
    S_dim = model.V.shape[2]
    full = model.Sigma is not None
    if full and accs.S2 is None:
        raise KaldiError(
            "sgmm2 update: full-covariance model but the accumulators "
            "carry no full scatter (S2) — they were accumulated "
            "against a diagonal model or written by an older tool; "
            "re-run accumulation with this model")

    # --- v_jk: per-substate SPD solve
    #   H_jk = Σ_i γ_jki M_iᵀ Σ_i⁻¹ M_i,  g_jk = Σ_i M_iᵀ Σ_i⁻¹ y_jki
    # MtP = MᵀΣ⁻¹, (I, S, D) — full precision or the diag fast path
    if full:
        P, _logdet = model.precision()                   # (I, D, D)
        MtP = np.einsum("idr,ide->ire", model.M, P)
    else:
        MtP = np.einsum("idr,id->ird", model.M, 1.0 / model.var)
    H = np.einsum("jki,ire,ies->jkrs", accs.gamma, MtP, model.M)
    g = np.einsum("ire,jkie->jkr", MtP, accs.y)
    V = model.V.copy()
    occ_jk = accs.gamma.sum(axis=2)                      # (J, K)
    for jj in range(J):
        for kk in range(K):
            if occ_jk[jj, kk] < 1e-3:
                continue
            V[jj, kk] = np.linalg.solve(
                H[jj, kk] + 1e-4 * np.eye(S_dim), g[jj, kk])

    # --- M_i: per-Gaussian least squares over substates
    Ynum = np.einsum("jkid,jks->ids", accs.y, V)         # (I, D, S)
    Q = np.einsum("jki,jkr,jks->irs", accs.gamma, V, V)  # (I, S, S)
    M = model.M.copy()
    occ_i = accs.gamma.sum(axis=(0, 1))
    for ii in range(I):
        if occ_i[ii] < 1e-3:
            continue
        M[ii] = np.linalg.solve(
            Q[ii] + 1e-4 * np.eye(S_dim), Ynum[ii].T).T

    # --- N_i: speaker-subspace update from (Z, R) stats
    N = model.N
    if (update_spk and N is not None and accs.Z is not None
            and accs.R is not None):
        N = N.copy()
        U = N.shape[2]
        for ii in range(I):
            if accs.R[ii].trace() < 1e-3:
                continue
            N[ii] = np.linalg.solve(
                accs.R[ii] + 1e-4 * np.eye(U), accs.Z[ii].T).T

    # --- w_i: REPEATED safeguarded quadratic-bound steps on the
    # weight auxiliary Σ_n Σ_i γ_ni log w_ni over all substate
    # vectors (flattened (J·K, S) with their occupancy) — the
    # reference's weight-iteration loop with step-halving on auxf
    # decrease (est-am-sgmm2 --weight-iters role)
    Vf = V.reshape(J * K, S_dim)
    gam_f = accs.gamma.reshape(J * K, I)
    occ_f = gam_f.sum(axis=1)
    Hw = 0.25 * np.einsum("n,nr,ns->rs", occ_f, Vf, Vf) \
        + 1e-4 * np.eye(S_dim)

    def w_logits_auxf(wm):
        """(logits, normalizer, auxf) — computed once per candidate."""
        lg = Vf @ wm.T
        norm = np.asarray(jax.nn.logsumexp(jnp.asarray(lg), axis=1,
                                           keepdims=True))
        return lg, norm, float(np.sum(gam_f * (lg - norm)))

    w = model.w.copy()
    logits, norm, base = w_logits_auxf(w)
    for _ in range(max(w_iters, 1)):
        cur = np.exp(logits - norm)
        grad = np.einsum("ni,ns->is", gam_f - occ_f[:, None] * cur, Vf)
        step = np.linalg.solve(Hw, grad.T).T
        scale = w_step
        for _ in range(8):                               # halving guard
            cand = w + scale * step
            c_logits, c_norm, c_auxf = w_logits_auxf(cand)
            if c_auxf >= base - 1e-9:
                w, logits, norm, base = cand, c_logits, c_norm, c_auxf
                break
            scale *= 0.5
        else:
            break                                        # no progress

    # --- c_jk: substate weights
    occ_j = occ_jk.sum(axis=1)
    c = np.where(occ_j[:, None] > 0,
                 occ_jk / np.maximum(occ_j[:, None], 1e-30), model.c)
    # keep padded substates dead
    c = np.where(model.c > 0, c, 0.0)
    c /= np.maximum(c.sum(axis=1, keepdims=True), 1e-30)

    # --- Σ_i: shared covariance from speaker-normalized scatter
    mu = np.einsum("ids,jks->jkid", M, V)
    var = model.var.copy()
    Sigma = None if not full else model.Sigma.copy()
    for ii in range(I):
        if occ_i[ii] < 1.0:
            continue
        if full:
            # Σ_i = [S2 − Σ_jk (y μᵀ + μ yᵀ) + Σ_jk γ μμᵀ] / occ,
            # eigenvalues floored at min_var (the reference's
            # covariance flooring contract)
            ymu = np.einsum("jkd,jke->de", accs.y[:, :, ii],
                            mu[:, :, ii])
            mumu = np.einsum("jk,jkd,jke->de", accs.gamma[:, :, ii],
                             mu[:, :, ii], mu[:, :, ii])
            Sg = (accs.S2[ii] - ymu - ymu.T + mumu) / occ_i[ii]
            Sg = 0.5 * (Sg + Sg.T)
            evals, evecs = np.linalg.eigh(Sg)
            evals = np.maximum(evals, min_var)
            Sigma[ii] = (evecs * evals) @ evecs.T
            var[ii] = np.diag(Sigma[ii])
        else:
            ex2 = accs.S[ii] / occ_i[ii]
            cross = np.einsum("jk,jkd->d",
                              accs.gamma[:, :, ii] / occ_i[ii],
                              mu[:, :, ii] ** 2) \
                - 2 * np.einsum("jkd,jkd->d",
                                accs.y[:, :, ii] / occ_i[ii],
                                mu[:, :, ii]) + ex2
            var[ii] = np.maximum(cross, min_var)
    return Sgmm2(M=M, w=w, var=var, V=V, c=c, N=N, Sigma=Sigma)


def split_substates(model: Sgmm2, accs: Sgmm2Accs, target: int,
                    perturb: float = 0.05, seed: int = 0) -> Sgmm2:
    """Increase the total substate count toward ``target`` by
    splitting the highest-occupancy substates (sgmm2-mixup /
    MleAmSgmm2Updater::SplitSubstates): each split duplicates v_jk
    with ± a small perturbation and halves c_jk."""
    rng = np.random.default_rng(seed)
    J, K, S = model.V.shape
    occ = accs.gamma.sum(axis=2)                        # (J, K)
    alive = (model.c > 0)
    total = int(alive.sum())
    n_split = max(0, target - total)
    if n_split == 0:
        return model
    # rank alive substates by occupancy
    flat = [(occ[jj, kk], jj, kk) for jj in range(J)
            for kk in range(K) if alive[jj, kk]]
    flat.sort(reverse=True)
    grow = {}
    for cnt, jj, kk in flat[:n_split]:
        grow.setdefault(jj, []).append(kk)
    # Perturbation in the NATURAL metric (the reference's
    # SplitSubstates uses 0.1·H_k^{-1/2}·r): the raw v-space scale is
    # meaningless once M has fit the data — H = avg Σ_i w̄_i
    # M_iᵀΣ⁻¹M_i is the per-unit loglike curvature, so
    # H^{-1/2}-scaled noise moves the means by ~perturb·σ.
    if model.Sigma is not None:
        P, _ = model.precision()
        MtSiM = np.einsum("idr,ide,ies->irs", model.M, P, model.M)
    else:
        MtSiM = np.einsum("idr,id,ids->irs", model.M,
                          1.0 / model.var, model.M)
    gbar = accs.gamma.sum(axis=(0, 1))
    gbar = gbar / max(gbar.sum(), 1e-30)
    H_avg = np.einsum("i,irs->rs", gbar, MtSiM) + 1e-4 * np.eye(S)
    L = np.linalg.cholesky(H_avg)
    K_new = K + max(len(v) for v in grow.values())
    V = np.zeros((J, K_new, S))
    c = np.zeros((J, K_new))
    V[:, :K] = model.V
    c[:, :K] = model.c
    for jj, kks in grow.items():
        nxt = K
        for kk in kks:
            d = perturb * np.linalg.solve(L.T, rng.standard_normal(S))
            V[jj, nxt] = model.V[jj, kk] + d
            V[jj, kk] = model.V[jj, kk] - d
            c[jj, nxt] = c[jj, kk] = model.c[jj, kk] / 2.0
            nxt += 1
    log.info("split_substates: %d → %d substates (K %d → %d)", total,
             int((c > 0).sum()), K, K_new)
    return Sgmm2(M=model.M, w=model.w, var=model.var, V=V, c=c,
                 N=model.N, Sigma=model.Sigma)


def estimate_speaker_vector(model: Sgmm2, feats: np.ndarray,
                            pdf_ali: np.ndarray,
                            num_iters: int = 2) -> np.ndarray:
    """MAP speaker vector u_s from aligned frames
    (MleSgmm2SpeakerAccs::Update):
    u = (I + Σ γ_i N_iᵀΣ⁻¹N_i)⁻¹ Σ_i N_iᵀΣ⁻¹ Σ_t γ_i(t)(x_t − μ)."""
    if model.N is None:
        raise KaldiError("model has no speaker subspace")
    U = model.N.shape[2]
    u = np.zeros(U)
    x = jnp.asarray(feats, jnp.float32)
    j = jnp.asarray(np.asarray(pdf_ali, np.int32))
    if model.Sigma is not None:
        P, _ = model.precision()                         # (I, D, D)
        NtSi = np.einsum("idu,ide->ieu", model.N, P)     # Σ⁻¹N (I,D,U)
    else:
        NtSi = np.einsum("idu,id->idu", model.N, 1.0 / model.var)
    H_base = np.einsum("idu,idv->iuv", NtSi, model.N)    # (I, U, U)
    for _ in range(num_iters):
        post, _norms, _xi = _frame_posteriors(model, x, j, u)
        gi = np.asarray(jnp.sum(post, axis=1), np.float64)   # (T, I)
        mu = model.means()[np.asarray(pdf_ali, np.int32)]
        resid = np.einsum("tki,tkid->tid", np.asarray(post, np.float64),
                          np.asarray(x)[:, None, None, :] - mu)
        g = np.einsum("idu,tid->u", NtSi, resid)
        H = np.eye(U) + np.einsum("ti,iuv->uv", gi, H_base)
        u = np.linalg.solve(H, g)
    return u


def train_sgmm(feats: Dict[str, np.ndarray],
               pdf_alis: Dict[str, np.ndarray],
               num_pdfs: int, num_gauss: int = 8, subspace: int = 4,
               num_iters: int = 6, seed: int = 0,
               target_substates: int = 0,
               spk_subspace: int = 0,
               utt2spk: Optional[Dict[str, str]] = None,
               full_cov: bool = False) -> Tuple[Sgmm2, list]:
    """EM with fixed alignments (steps/train_sgmm2.sh inner loop
    without realignment).  With ``target_substates`` the substates are
    split at the halfway iteration (the recipe's --increase-dim-iters
    shape); with ``spk_subspace`` + ``utt2spk``, speaker vectors are
    re-estimated each iteration and the N_i subspace is trained.
    Returns (model, per-iter avg loglikes)."""
    utts = sorted(feats)
    allf = np.concatenate([feats[u] for u in utts])
    alla = np.concatenate([np.asarray(pdf_alis[u], np.int32)
                           for u in utts])
    if alla.max() >= num_pdfs:
        raise KaldiError("alignment pdf out of range")
    model = init_sgmm(num_pdfs, allf.shape[1], num_gauss, subspace,
                      allf.mean(0), allf.var(0) + 1e-3,
                      spk_subspace=spk_subspace, seed=seed,
                      full_cov=full_cov)
    spk_of = utt2spk or {}
    likes = []
    for it in range(num_iters):
        if spk_subspace and utt2spk:
            spk_u = {s: estimate_speaker_vector(
                model,
                np.concatenate([feats[u] for u in utts
                                if spk_of[u] == s]),
                np.concatenate([np.asarray(pdf_alis[u], np.int32)
                                for u in utts if spk_of[u] == s]))
                for s in sorted(set(spk_of.values()))}
            accs = None
            for u in utts:
                a = accumulate(model, feats[u],
                               np.asarray(pdf_alis[u], np.int32),
                               spk_u=spk_u[spk_of[u]])
                accs = a if accs is None else accs + a
        else:
            accs = accumulate(model, allf, alla)
        likes.append(accs.tot_like / accs.tot_frames)
        model = update(model, accs)
        # split EARLY (a third of the way in, once the subspace has
        # roughly converged) so the split substates get enough EM
        # iterations to specialize — splitting at the midpoint was
        # measured to leave them still symmetric at convergence
        if (target_substates and it == max(num_iters // 3, 1)
                and model.num_substates * num_pdfs < 4 * target_substates):
            model = split_substates(model, accs, target_substates,
                                    seed=seed)
        log.info("sgmm2 iter %d: avg loglike %.4f (substates %d)", it,
                 likes[-1], int((model.c > 0).sum()))
    return model, likes


def write_sgmm2(path: str, model: Sgmm2) -> None:
    """Kaldi-style token-framed SGMM2 serialization (<SGMM2> header,
    dims, then M/w/var/V/c (+N) as FM matrices; am-sgmm2.h Write role
    — token layout is ours, framing primitives are core/io)."""
    from kaldi_tpu.core import io as kio
    J, K, S = model.V.shape
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<SGMM2>")
        for tok, v in (("<NUMPDFS>", J),
                       ("<NUMSUBSTATES>", K),
                       ("<NUMGAUSS>", model.M.shape[0]),
                       ("<DIM>", model.M.shape[1]),
                       ("<SUBSPACE>", S),
                       ("<SPKSUBSPACE>", model.spk_dim)):
            kio.write_token(f, tok)
            kio.write_basic_int32(f, v)
        kio.write_token(f, "<M>")
        for i in range(model.M.shape[0]):
            kio.write_matrix(f, model.M[i])
        kio.write_token(f, "<W>")
        kio.write_matrix(f, model.w)
        kio.write_token(f, "<VARS>")
        kio.write_matrix(f, model.var)
        kio.write_token(f, "<V>")
        kio.write_matrix(f, model.V.reshape(J * K, S))
        kio.write_token(f, "<C>")
        kio.write_matrix(f, model.c)
        if model.N is not None:
            kio.write_token(f, "<N>")
            for i in range(model.N.shape[0]):
                kio.write_matrix(f, model.N[i])
        if model.Sigma is not None:
            kio.write_token(f, "<SIGMA>")
            for i in range(model.Sigma.shape[0]):
                kio.write_matrix(f, model.Sigma[i])
        kio.write_token(f, "</SGMM2>")


def read_sgmm2(path: str) -> Sgmm2:
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<SGMM2>")
        dims = {}
        for tok in ("<NUMPDFS>", "<NUMSUBSTATES>", "<NUMGAUSS>",
                    "<DIM>", "<SUBSPACE>", "<SPKSUBSPACE>"):
            kio.expect_token(f, tok)
            dims[tok] = kio.read_basic_int32(f)
        kio.expect_token(f, "<M>")
        M = np.stack([kio.read_matrix(f)
                      for _ in range(dims["<NUMGAUSS>"])])
        kio.expect_token(f, "<W>")
        w = kio.read_matrix(f)
        kio.expect_token(f, "<VARS>")
        var = kio.read_matrix(f)
        kio.expect_token(f, "<V>")
        V = np.asarray(kio.read_matrix(f)).reshape(
            dims["<NUMPDFS>"], dims["<NUMSUBSTATES>"],
            dims["<SUBSPACE>"])
        kio.expect_token(f, "<C>")
        c = np.asarray(kio.read_matrix(f))
        N = None
        if dims["<SPKSUBSPACE>"]:
            kio.expect_token(f, "<N>")
            N = np.stack([kio.read_matrix(f)
                          for _ in range(dims["<NUMGAUSS>"])])
        tok = kio.read_token(f)
        Sigma = None
        if tok == "<SIGMA>":
            Sigma = np.stack([kio.read_matrix(f)
                              for _ in range(dims["<NUMGAUSS>"])])
            tok = kio.read_token(f)
        if tok != "</SGMM2>":
            raise KaldiError(f"expected </SGMM2>, got {tok}")
        return Sgmm2(M=np.asarray(M, np.float64),
                     w=np.asarray(w, np.float64),
                     var=np.asarray(var, np.float64),
                     V=np.asarray(V, np.float64),
                     c=np.asarray(c, np.float64),
                     N=None if N is None else np.asarray(N, np.float64),
                     Sigma=None if Sigma is None
                     else np.asarray(Sigma, np.float64))
