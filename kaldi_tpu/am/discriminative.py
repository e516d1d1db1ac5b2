"""Discriminative sequence training objectives: MMI and sMBR over
denominator lattices.

Parity target: the reference's lattice-based sequence training —
nnet1's sMBR/MMI (src/nnet/nnet-loss.h roles) and nnet3's
discriminative training (src/nnet3/nnet-discriminative-training.h,
src/lat/lattice-functions.h LatticeForwardBackward{,Mpe}Variants):
  MMI  objf = κ·num-path score − log Z_den
  sMBR objf = E_den[frame accuracy]
with gradients wrt the per-frame pdf log-likelihood matrix.

Redesign: the denominator lattice (from decoding training
data with a weak LM) is converted once on host into a TIME-SYNCHRONOUS
dense form — states bucketed by frame, arcs padded to fixed width —
then both objectives are a single `lax.scan` over frames:
  * log Z via masked segment-logsumexp (the chain denominator pattern,
    am/chain.py);
  * E[acc] via the EXPECTATION SEMIRING carried alongside alpha:
    ae'[d] = Σ_k softmax-weight(k)·(ae[s_k] + acc_k), so the sMBR
    objective is a closed differentiable expression and `jax.grad`
    yields the exact sMBR gradient (no second-order trickery).
Occupancies γ_den(t, pdf) are `jax.grad` of log Z — the
forward-backward "backward pass" is the autodiff transpose, as in the
chain code.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import get_logger

log = get_logger(__name__)

NEG_INF = -1e30


@dataclasses.dataclass
class DenseLattice:
    """Time-synchronous padded lattice.

    T frames; ≤K states per frame boundary (boundary 0 = before frame
    0, boundary T = after the last frame); ≤A arcs per frame.
    Arc j of frame t goes from state src[t, j] (boundary t) to
    dst[t, j] (boundary t+1) emitting pdf[t, j] with graph weight
    w[t, j] (log domain, negated costs).  Padded arcs have mask 0.
    final[k]: log final weight of boundary-T state k (NEG_INF if not
    final).  start state is boundary-0 index 0.
    """

    src: np.ndarray        # (T, A) int32
    dst: np.ndarray        # (T, A) int32
    pdf: np.ndarray        # (T, A) int32
    w: np.ndarray          # (T, A) float32
    mask: np.ndarray       # (T, A) float32
    final: np.ndarray      # (K,) float32
    num_states: np.ndarray  # (T+1,) int32 (diagnostic)

    @property
    def T(self) -> int:
        return self.src.shape[0]

    @property
    def K(self) -> int:
        return self.final.shape[0]


def lattice_to_dense(lat, tid_to_pdf: np.ndarray,
                     acoustic_scale_in_w: bool = False,
                     K: Optional[int] = None,
                     A: Optional[int] = None) -> DenseLattice:
    """Raw state-level Lattice → DenseLattice.

    Every arc must be emitting (ilabel != 0); the decoder's raw
    lattices satisfy this (ε arcs are pre-composed away).  Arc weight
    = −graph_cost (+ −acoustic_cost if acoustic_scale_in_w; normally
    the acoustic score is re-derived from the CURRENT model's `scores`
    inside the objective, the lattice only contributes graph weights —
    matching the reference, which recomputes acoustics each pass).
    """
    n = lat.num_states
    # frame time of each state
    time = np.full(n, -1, np.int64)
    time[lat.start] = 0
    for s in lat.top_order():
        if time[s] < 0:
            continue
        for a in lat.arcs[s]:
            if a.ilabel == 0:
                raise ValueError("lattice_to_dense: ε arc (run "
                                 "eps-removal first)")
            t2 = time[s] + 1
            if time[a.nextstate] >= 0 and time[a.nextstate] != t2:
                raise ValueError("lattice not time-synchronous")
            time[a.nextstate] = t2
    T = int(time.max())
    # renumber states within each frame boundary
    idx = np.zeros(n, np.int64)
    counts = np.zeros(T + 1, np.int64)
    for s in range(n):
        if time[s] >= 0:
            idx[s] = counts[time[s]]
            counts[time[s]] += 1
    Kmax = int(counts.max()) if K is None else K
    arcs_per_t = np.zeros(T, np.int64)
    for s in range(n):
        if 0 <= time[s] < T:
            arcs_per_t[time[s]] += len(lat.arcs[s])
    Amax = int(arcs_per_t.max()) if A is None else A

    src = np.zeros((T, Amax), np.int32)
    dst = np.zeros((T, Amax), np.int32)
    pdf = np.zeros((T, Amax), np.int32)
    w = np.zeros((T, Amax), np.float32)
    mask = np.zeros((T, Amax), np.float32)
    fill = np.zeros(T, np.int64)
    for s in range(n):
        t = time[s]
        if not (0 <= t < T):
            continue
        for a in lat.arcs[s]:
            j = fill[t]
            src[t, j] = idx[s]
            dst[t, j] = idx[a.nextstate]
            pdf[t, j] = tid_to_pdf[a.ilabel]
            w[t, j] = -a.graph_cost - (a.acoustic_cost
                                       if acoustic_scale_in_w else 0.0)
            mask[t, j] = 1.0
            fill[t] += 1
    final = np.full(Kmax, NEG_INF, np.float32)
    for s, (gc, ac) in lat.finals.items():
        if time[s] == T:
            final[idx[s]] = -gc - (ac if acoustic_scale_in_w else 0.0)
    return DenseLattice(src=src, dst=dst, pdf=pdf, w=w, mask=mask,
                        final=final,
                        num_states=counts.astype(np.int32))


def remove_eps_arcs(lat):
    """Path-sum-preserving ε-removal on a raw lattice (the decoder's
    raw lattices carry within-frame ε arcs from graph ε transitions).

    Processing states in reverse topological order, each ε arc s→m is
    replaced by copies of m's (already ε-free) outgoing arcs with the
    ε weight folded into the graph cost, and m's final weight folded
    into s's (log-sum of totals).  Path sums — hence forward-backward
    posteriors — are exactly preserved; duplicate arcs simply
    enumerate distinct original paths.  Word olabels are kept
    best-effort (ε-arc olabel wins when the follower has none); this
    utility serves the discriminative objectives, which ignore
    olabels."""
    from kaldi_tpu.lattice.lattice import Lattice, LatticeArc
    order = lat.top_order()
    arcs: List[List] = [list(a) for a in lat.arcs]
    final_total = {s: -(gc + ac) for s, (gc, ac) in lat.finals.items()}
    for s in reversed(order):
        out = []
        for a in arcs[s]:
            if a.ilabel != 0:
                out.append(a)
                continue
            m = a.nextstate
            for b in arcs[m]:
                out.append(LatticeArc(
                    b.ilabel, a.olabel if a.olabel else b.olabel,
                    a.graph_cost + a.acoustic_cost + b.graph_cost,
                    b.acoustic_cost, b.nextstate))
            if m in final_total:
                w = final_total[m] - a.graph_cost - a.acoustic_cost
                if s in final_total:
                    final_total[s] = float(np.logaddexp(final_total[s], w))
                else:
                    final_total[s] = w
        arcs[s] = out
    out_lat = Lattice()
    for _ in range(lat.num_states):
        out_lat.add_state()
    out_lat.start = lat.start
    for s, alist in enumerate(arcs):
        out_lat.arcs[s] = alist
    for s, ft in final_total.items():
        out_lat.set_final(s, -ft, 0.0)
    return out_lat


def den_lattice_from_decoder(decoder, loglikes: np.ndarray
                             ) -> DenseLattice:
    """Decode one utterance into a pruned raw lattice and convert it
    for the sequence-training objectives (ε-removed, graph weights
    only — acoustics are re-derived from the model inside the
    objective, as the reference recomputes them each pass)."""
    raw, _best = decoder.decode_lattice(np.asarray(loglikes, np.float32))
    return lattice_to_dense(remove_eps_arcs(raw),
                            decoder.tid_to_pdf)


def _arc_scores(lat: DenseLattice, scores, acoustic_scale):
    """(T, A) total arc log-weights under the current model."""
    t_idx = jnp.arange(lat.T)[:, None]
    am = scores[t_idx, lat.pdf]                      # (T, A)
    return lat.w + acoustic_scale * am


def lattice_logz(lat: DenseLattice, scores, acoustic_scale: float = 1.0):
    """log Σ_paths exp(total path weight) — the denominator log-Z.
    `jax.grad(lattice_logz, argnums=1)` is the per-(t, pdf) den
    occupancy γ_den times acoustic_scale."""
    aw = _arc_scores(lat, scores, acoustic_scale)
    K = lat.K
    alpha0 = jnp.full((K,), NEG_INF).at[0].set(0.0)

    def step(alpha, xs):
        aw_t, src_t, dst_t, m_t = xs
        contrib = alpha[src_t] + aw_t + (1.0 - m_t) * NEG_INF
        nxt = jax.ops.segment_max(contrib, dst_t, num_segments=K)
        # logsumexp via max + sum of exps (segment ops, masked)
        shifted = jnp.exp(contrib - nxt[dst_t])
        tot = jax.ops.segment_sum(shifted * m_t, dst_t, num_segments=K)
        nxt = nxt + jnp.log(jnp.maximum(tot, 1e-30))
        nxt = jnp.where(tot > 0, nxt, NEG_INF)
        return nxt, None

    alphaT, _ = jax.lax.scan(
        step, alpha0,
        (aw, jnp.asarray(lat.src), jnp.asarray(lat.dst),
         jnp.asarray(lat.mask)))
    return jax.scipy.special.logsumexp(alphaT + jnp.asarray(lat.final))


def mmi_objf(lat: DenseLattice, scores, num_pdf: jnp.ndarray,
             acoustic_scale: float = 1.0):
    """MMI per-utterance objective κ·Σ_t s(t, num_pdf_t) − log Z_den.
    Gradient wrt scores = κ·(1{num} − γ_den)."""
    t_idx = jnp.arange(lat.T)
    num = acoustic_scale * jnp.sum(scores[t_idx, num_pdf])
    return num - lattice_logz(lat, scores, acoustic_scale)


def smbr_objf(lat: DenseLattice, scores, acc: jnp.ndarray,
              acoustic_scale: float = 1.0):
    """Expected accuracy E_den[Σ_t acc(t, arc)] via the expectation
    semiring.  `acc` is (T, A): per-arc frame accuracy (typically
    1.0 where the arc's phone matches the reference alignment's
    phone at t — `frame_accuracy` builds it).  jax.grad wrt scores
    is the exact sMBR gradient."""
    aw = _arc_scores(lat, scores, acoustic_scale)
    K = lat.K
    alpha0 = jnp.full((K,), NEG_INF).at[0].set(0.0)
    ae0 = jnp.zeros((K,))

    def step(carry, xs):
        alpha, ae = carry
        aw_t, src_t, dst_t, m_t, acc_t = xs
        contrib = alpha[src_t] + aw_t + (1.0 - m_t) * NEG_INF
        nxt = jax.ops.segment_max(contrib, dst_t, num_segments=K)
        p = jnp.exp(contrib - nxt[dst_t]) * m_t          # (A,)
        tot = jax.ops.segment_sum(p, dst_t, num_segments=K)
        nxt_alpha = jnp.where(tot > 0,
                              nxt + jnp.log(jnp.maximum(tot, 1e-30)),
                              NEG_INF)
        # expectation carried per state: weighted mean of incoming
        # (ae[src] + acc)
        e_contrib = p * (ae[src_t] + acc_t)
        e_tot = jax.ops.segment_sum(e_contrib, dst_t, num_segments=K)
        nxt_ae = jnp.where(tot > 0, e_tot / jnp.maximum(tot, 1e-30), 0.0)
        return (nxt_alpha, nxt_ae), None

    (alphaT, aeT), _ = jax.lax.scan(
        step, (alpha0, ae0),
        (aw, jnp.asarray(lat.src), jnp.asarray(lat.dst),
         jnp.asarray(lat.mask), acc))
    wfin = alphaT + jnp.asarray(lat.final)
    logz = jax.scipy.special.logsumexp(wfin)
    pfin = jnp.exp(wfin - logz)
    return jnp.sum(pfin * aeT)


def frame_accuracy(lat: DenseLattice, ref_pdf: np.ndarray,
                   pdf_to_phone: Optional[np.ndarray] = None
                   ) -> np.ndarray:
    """(T, A) per-arc accuracy: 1 where the arc's phone (or pdf, when
    no mapping is given) equals the reference at frame t — the frame-
    level sMBR criterion (the reference's default in nnet1 sMBR)."""
    arcs = lat.pdf
    ref = np.asarray(ref_pdf)[:, None]
    if pdf_to_phone is not None:
        arcs = pdf_to_phone[arcs]
        ref = pdf_to_phone[ref]
    return (arcs == ref).astype(np.float32) * lat.mask


def den_occupancies(lat: DenseLattice, scores,
                    acoustic_scale: float = 1.0):
    """γ_den(t, pdf): derivative of log Z wrt scores, rescaled —
    sums to 1 per frame (diagnostic / EBW-style uses)."""
    g = jax.grad(lambda s: lattice_logz(lat, s, acoustic_scale))(scores)
    return g / acoustic_scale
