"""LF-MMI ('chain') training objective.

Parity targets: src/chain/chain-training.h (ComputeChainObjfAndDeriv),
chain-den-graph.h (DenominatorGraph, leaky-HMM initial probs),
chain-denominator.h (DenominatorComputation with leaky_hmm_coefficient),
chain-supervision.h (Supervision), and the recipe-side phone LM
estimation (chainbin/chain-est-phone-lm.cc).

Design: the denominator forward recursion is a log-space
lax.scan over frames with per-arc gathers and segment-logsumexp
recombination; gradients (the forward-backward posteriors) come from
jax.grad differentiating through the forward pass — d logZ / d score =
expected occupancy, so XLA's autodiff *is* the backward pass of
chain-kernels.cu, with jax.checkpoint rematerializing alpha instead of
storing T×S betas.

Divergences from the reference, by design:
  * The phone LM is closed over backoff into dense per-state next-phone
    distributions at graph-build time (the reference builds a backoff
    FST, epsilon-removes and minimizes it — same result, but the dense
    closure keeps the on-device recursion epsilon-free and uniform).
  * Leaky-HMM is folded into the forward scan as a per-frame logaddexp
    against the stationary distribution instead of a special state.
  * The numerator is a flexible-boundary segment chain (a superset of
    the reference's ±frame-tolerance supervision), with the
    normalization-FST weights (phone-LM scores + topology transition
    probs + initial/final probs) threaded in as per-segment additive
    weights.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.tree import ContextDependency

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# Phone LM (chain-est-phone-lm role)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhoneLm:
    """Backoff n-gram phone LM closed into dense per-history
    distributions (the den-graph states).

    States are retained histories (tuples of phone indices, length
    1..order-1, always ending in the current phone); transitions from
    history h on phone c land at the longest retained suffix of h+(c,).
    Witten–Bell interpolation down to the unigram supplies mass for
    unseen continuations, so every row is a full distribution over
    next-phone ∪ {end-of-sequence}.
    """
    order: int
    phones: List[int]                      # sorted phone symbols
    hists: List[Tuple[int, ...]]           # per-state history (phone indices)
    next_logp: np.ndarray                  # (S, P) log p(c | h)
    final_logp: np.ndarray                 # (S,) log p(</s> | h)
    next_state: np.ndarray                 # (S, P) int32 dst state ids

    @property
    def num_states(self) -> int:
        return len(self.hists)

    def state_of(self, phone_seq: Sequence[int]) -> int:
        """Longest retained suffix of the given phone sequence (must end
        in at least one phone)."""
        if not hasattr(self, "_hist_index"):
            self._hist_index = {h: i for i, h in enumerate(self.hists)}
            self._pidx = {p: i for i, p in enumerate(self.phones)}
        idx = [self._pidx[p] for p in phone_seq]
        for k in range(min(len(idx), self.order - 1), 0, -1):
            h = tuple(idx[-k:])
            if h in self._hist_index:
                return self._hist_index[h]
        raise KaldiError(f"PhoneLm.state_of: no state for {phone_seq}")


def estimate_phone_lm(phone_seqs: Sequence[Sequence[int]],
                      phones: Sequence[int],
                      order: int = 2,
                      min_hist_count: int = 1) -> PhoneLm:
    """Estimate a Witten–Bell-interpolated n-gram phone LM from training
    phone sequences (chain recipes run chain-est-phone-lm on the
    numerator alignments).  Histories with count < min_hist_count are
    pruned (their mass reaches the model through backoff)."""
    phones = sorted(phones)
    pidx = {p: i for i, p in enumerate(phones)}
    P = len(phones)
    FINAL = P                              # index of </s> in count tables

    # counts[h][c] for histories h of length 0..order-1
    counts: Dict[Tuple[int, ...], np.ndarray] = {}

    def bump(h: Tuple[int, ...], c: int) -> None:
        if h not in counts:
            counts[h] = np.zeros(P + 1)
        counts[h][c] += 1

    for seq in phone_seqs:
        idx = [pidx[p] for p in seq]
        for t, c in enumerate(idx + [FINAL]):
            for k in range(0, order):
                if k <= t:
                    bump(tuple(idx[t - k:t]), c)

    if () not in counts:
        counts[()] = np.ones(P + 1)

    # Witten–Bell closure, shortest histories first
    probs: Dict[Tuple[int, ...], np.ndarray] = {}
    uni_counts = counts[()] + 1e-3          # floor so every phone reachable
    probs[()] = uni_counts / uni_counts.sum()
    for h in sorted(counts, key=len):
        if h == ():
            continue
        c = counts[h]
        tot = c.sum()
        uniq = np.count_nonzero(c)
        lam = tot / (tot + uniq)            # weight on the ML estimate
        probs[h] = lam * (c / max(tot, 1.0)) + (1 - lam) * probs[h[1:]]

    # retained states: histories of length >= 1 whose count passes the
    # threshold; always retain every unigram history so fallback exists
    kept = [h for h in counts
            if len(h) >= 1 and (len(h) == 1
                                or counts[h].sum() >= min_hist_count)]
    for p in range(P):
        if (p,) not in counts:
            kept.append((p,))
            probs[(p,)] = probs[()]
    kept = sorted(set(kept), key=lambda h: (len(h), h))
    hist_index = {h: i for i, h in enumerate(kept)}

    S = len(kept)
    next_logp = np.zeros((S, P), np.float32)
    final_logp = np.zeros(S, np.float32)
    next_state = np.zeros((S, P), np.int32)
    for i, h in enumerate(kept):
        dist = probs[h]
        next_logp[i] = np.log(np.maximum(dist[:P], 1e-30))
        final_logp[i] = np.log(max(dist[FINAL], 1e-30))
        for c in range(P):
            ext = h + (c,)
            dst = None
            for k in range(min(len(ext), order - 1), 0, -1):
                if ext[-k:] in hist_index:
                    dst = hist_index[ext[-k:]]
                    break
            next_state[i, c] = dst
    return PhoneLm(order=order, phones=list(phones), hists=kept,
                   next_logp=next_logp, final_logp=final_logp,
                   next_state=next_state)


# ---------------------------------------------------------------------------
# Denominator graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DenominatorGraph:
    """Flat arc-list HMM over pdf-ids (chain-den-graph.h equivalent).

    `initial` doubles as the leaky-HMM target distribution: it is the
    stationary distribution of the transition matrix (the reference
    computes the same thing by iterating the HMM for ~100 steps to get
    its DenominatorGraph initial probs)."""
    num_states: int
    src: np.ndarray        # (A,) int32
    dst: np.ndarray        # (A,) int32
    pdf: np.ndarray        # (A,) int32
    logw: np.ndarray       # (A,) f32
    initial: np.ndarray    # (S,) f32 log initial probs (stationary dist)
    final: np.ndarray      # (S,) f32 log final probs
    lm: Optional[PhoneLm] = None          # the phone LM behind the graph
    # per-state topology log-probs (for normalization-FST weights)
    l_self: Optional[np.ndarray] = None   # (S,) f32
    l_fwd: Optional[np.ndarray] = None    # (S,) f32
    # per-state pdfs (self-loop / phone-entry): disambiguate s==d arcs
    # that are LM RE-ENTRIES (same phone again → entry pdf) from true
    # HMM self-loops — the dense fast path needs the distinction
    state_self_pdf: Optional[np.ndarray] = None   # (S,) i32
    state_entry_pdf: Optional[np.ndarray] = None  # (S,) i32
    # context-dependent den graphs (left-biphone trees): den states are
    # (lm-state, left-phone) pairs; these per-LM-STATE views back the
    # normalization-FST weight computation, which walks LM states
    lm_initial: Optional[np.ndarray] = None   # (S_lm,) f32
    lm_l_self: Optional[np.ndarray] = None    # (S_lm,) f32
    lm_l_fwd: Optional[np.ndarray] = None     # (S_lm,) f32
    lm_final: Optional[np.ndarray] = None     # (S_lm,) f32
    exp_index: Optional[Dict] = None          # (lm-state, l-idx) → state

    def norm_view(self):
        """(initial, l_self, l_fwd, final) indexed by LM STATE — for
        normalization-FST weights along a numerator phone chain.  For
        monophone-tree graphs den states ARE LM states; CD graphs
        carry aggregated per-LM-state arrays."""
        if self.lm_initial is not None:
            return (self.lm_initial, self.lm_l_self, self.lm_l_fwd,
                    self.lm_final)
        return self.initial, self.l_self, self.l_fwd, self.final

    def initial_for(self, hist_phones) -> float:
        """log initial prob for a numerator chain whose phone history
        (ids) ends at the current phone; resolves the exact expanded
        (lm-state, left-phone) den state when it exists."""
        g = self.lm.state_of(hist_phones)
        if self.exp_index is None:
            return float(self.initial[g])
        if len(hist_phones) >= 2:
            li = self.lm._pidx.get(hist_phones[-2], -1)
            st = self.exp_index.get((g, li))
            if st is not None:
                return float(self.initial[st])
        return float(self.lm_initial[g])


def _stationary_distribution(S: int, src: np.ndarray, dst: np.ndarray,
                             w: np.ndarray, iters: int = 100) -> np.ndarray:
    """Power-iterate p ← normalize(pᵀM) over the (sub-stochastic, final
    mass leaks out) transition matrix; the reference's den-graph initial
    probs come from the same fixed-point."""
    M = np.zeros((S, S))
    np.add.at(M, (src, dst), np.exp(w))
    p = np.full(S, 1.0 / S)
    for _ in range(iters):
        p = p @ M
        p /= p.sum()
    return np.log(np.maximum(p, 1e-30)).astype(np.float32)


def make_denominator_graph(phone_seqs: Sequence[Sequence[int]],
                           tree: ContextDependency,
                           topo: HmmTopology,
                           interp: float = 1e-3,
                           order: int = 2,
                           min_hist_count: int = 1) -> DenominatorGraph:
    """Build the den graph from training phone sequences: an n-gram
    phone LM (chain-est-phone-lm role; Witten–Bell backoff closed into
    dense rows) expanded through the chain topology.

    State = LM history ending in the current phone; arcs to the next
    phone carry its *forward* pdf and weight log p_fwd + log p(c | h);
    self-loops carry the current phone's self-loop pdf and log p_self;
    finals carry log p_fwd + log p(</s> | h) so each state's total
    outgoing mass is exactly 1 (p_self + p_fwd).

    `interp` is kept for API compatibility (the WB unigram floor plays
    its smoothing role)."""
    del interp
    phones = sorted(topo.phones)
    lm = estimate_phone_lm(phone_seqs, phones, order=order,
                           min_hist_count=min_hist_count)
    if tree.context_width == 2 and tree.central_position == 1:
        return _make_den_graph_biphone(lm, tree, topo, phones)
    if tree.context_width != 1:
        raise KaldiError(
            "make_denominator_graph: context-dependent den graphs "
            "support left-biphone trees (context_width 2, central "
            "position 1 — the chain build_tree.sh standard); a "
            f"({tree.context_width},{tree.central_position}) tree "
            "needs delayed-window expansion (not implemented)")
    S = lm.num_states
    P = len(phones)

    def pdfs_of(phone):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        entry = topo.topology_for_phone(phone)
        st = entry[0]
        return (tree.compute(window, st.forward_pdf_class),
                tree.compute(window, st.self_loop_pdf_class))

    # transition probs of the chain topo state (0.5 / 0.5 by default)
    def topo_probs(phone):
        entry = topo.topology_for_phone(phone)
        trans = entry[0].transitions
        p_self = sum(p for ns, p in trans if ns == 0)
        p_fwd = sum(p for ns, p in trans if ns != 0)
        return math.log(max(p_self, 1e-10)), math.log(max(p_fwd, 1e-10))

    fwd_pdf = np.zeros(P, np.int32)
    slf_pdf = np.zeros(P, np.int32)
    l_self_p = np.zeros(P, np.float32)
    l_fwd_p = np.zeros(P, np.float32)
    for i, ph in enumerate(phones):
        fwd_pdf[i], slf_pdf[i] = pdfs_of(ph)
        l_self_p[i], l_fwd_p[i] = topo_probs(ph)

    cur = np.asarray([h[-1] for h in lm.hists], np.int32)  # current phone idx
    l_self = l_self_p[cur]
    l_fwd = l_fwd_p[cur]

    # self-loops
    src = [np.arange(S, dtype=np.int32)]
    dst = [np.arange(S, dtype=np.int32)]
    pdf = [slf_pdf[cur]]
    logw = [l_self]
    # cross arcs: dense (S, P)
    ss, cc = np.meshgrid(np.arange(S, dtype=np.int32),
                         np.arange(P, dtype=np.int32), indexing="ij")
    src.append(ss.ravel())
    dst.append(lm.next_state[ss, cc].ravel().astype(np.int32))
    pdf.append(fwd_pdf[cc].ravel())
    logw.append((l_fwd[:, None] + lm.next_logp)[ss, cc].ravel())

    src = np.concatenate(src)
    dst = np.concatenate(dst)
    pdf = np.concatenate(pdf)
    logw = np.concatenate(logw).astype(np.float32)
    final = (l_fwd + lm.final_logp).astype(np.float32)
    initial = _stationary_distribution(S, src, dst, logw)
    return DenominatorGraph(
        num_states=S, src=src, dst=dst, pdf=pdf, logw=logw,
        initial=initial, final=final, lm=lm,
        l_self=l_self.astype(np.float32), l_fwd=l_fwd.astype(np.float32),
        state_self_pdf=slf_pdf[cur].astype(np.int32),
        state_entry_pdf=fwd_pdf[cur].astype(np.int32))


def _make_den_graph_biphone(lm: PhoneLm, tree, topo,
                            phones) -> DenominatorGraph:
    """Denominator graph for a LEFT-BIPHONE tree (context_width 2,
    central_position 1 — the reference chain/e2e build_tree.sh
    standard): a state must know its instance's (left, center) phone
    window, so den states are (lm-state, left-phone) pairs.

    LM states with history length ≥ 2 determine their left phone
    (hist[-2]) — only backoff states (history ≤ 1) split per arriving
    left context, so the expansion adds at most ~|phones|² states over
    the phone-LM state count and the dense matmul recursion path in
    denominator_logprob is unchanged.  Entry pdfs stay a function of
    the DESTINATION state (the dense path's requirement): the arc
    (g, l) --x--> (g', l'=center(g)) enters instance x with window
    (center(g), x) = (l', center(g')).  Ref: steps/nnet3/chain/
    build_tree.sh --context-width=2 --central-position=1,
    src/chain/chain-den-graph.h."""
    P = len(phones)
    pid = list(phones)                       # index -> phone id

    def topo_probs(phone):
        entry = topo.topology_for_phone(phone)
        trans = entry[0].transitions
        p_self = sum(p for ns, p in trans if ns == 0)
        p_fwd = sum(p for ns, p in trans if ns != 0)
        return math.log(max(p_self, 1e-10)), math.log(max(p_fwd, 1e-10))

    l_self_p = np.zeros(P, np.float32)
    l_fwd_p = np.zeros(P, np.float32)
    for i in range(P):
        l_self_p[i], l_fwd_p[i] = topo_probs(pid[i])

    # pdf tables over (left idx, center idx); left -1 = no left context
    fwd_tab = np.zeros((P + 1, P), np.int32)
    slf_tab = np.zeros((P + 1, P), np.int32)
    for li in range(-1, P):
        for ci in range(P):
            st = topo.topology_for_phone(pid[ci])[0]
            w = [pid[li] if li >= 0 else 0, pid[ci]]
            fwd_tab[li + 1, ci] = tree.compute(w, st.forward_pdf_class)
            slf_tab[li + 1, ci] = tree.compute(w, st.self_loop_pdf_class)

    S_lm = lm.num_states
    last = np.asarray([h[-1] for h in lm.hists], np.int32)
    # expanded states: canonical pairs for len-2 histories, plus every
    # (dst, left) pair one LM transition generates (dedup by dict)
    exp_index: Dict[Tuple[int, int], int] = {}
    exp_states: List[Tuple[int, int]] = []

    def sid(g: int, li: int) -> int:
        k = (g, li)
        s = exp_index.get(k)
        if s is None:
            s = len(exp_states)
            exp_index[k] = s
            exp_states.append(k)
        return s

    for g, h in enumerate(lm.hists):
        if len(h) >= 2:
            sid(g, int(h[-2]))
    # closure: transitions only depend on the source's LM state, so one
    # pass over (g, x) enumerates every reachable (dst, left) pair
    for g in range(S_lm):
        for x in range(P):
            sid(int(lm.next_state[g, x]), int(last[g]))

    S = len(exp_states)
    eg = np.asarray([g for g, _ in exp_states], np.int32)
    el = np.asarray([li for _, li in exp_states], np.int32)
    ec = last[eg]                               # center phone idx
    st_self = slf_tab[el + 1, ec]
    st_entry = fwd_tab[el + 1, ec]
    l_self = l_self_p[ec]
    l_fwd = l_fwd_p[ec]

    # self-loops
    src = [np.arange(S, dtype=np.int32)]
    dst = [np.arange(S, dtype=np.int32)]
    pdf = [st_self.astype(np.int32)]
    logw = [l_self]
    # cross arcs (S, P): dst = (next_state[g, x], center(g))
    ss, xx = np.meshgrid(np.arange(S, dtype=np.int32),
                         np.arange(P, dtype=np.int32), indexing="ij")
    dst_g = lm.next_state[eg[ss.ravel()], xx.ravel()]
    dst_l = ec[ss.ravel()]
    dmap = np.asarray([exp_index[(int(g), int(l))]
                       for g, l in zip(dst_g, dst_l)], np.int32)
    src.append(ss.ravel())
    dst.append(dmap)
    pdf.append(fwd_tab[dst_l + 1, last[dst_g]])
    logw.append(l_fwd[ss.ravel()]
                + lm.next_logp[eg[ss.ravel()], xx.ravel()])

    src = np.concatenate(src)
    dst = np.concatenate(dst)
    pdf = np.concatenate(pdf).astype(np.int32)
    logw = np.concatenate(logw).astype(np.float32)
    final = (l_fwd + lm.final_logp[eg]).astype(np.float32)
    initial = _stationary_distribution(S, src, dst, logw)

    # per-LM-state views for normalization weights
    lm_l_self = l_self_p[last]
    lm_l_fwd = l_fwd_p[last]
    lm_final = (lm_l_fwd + lm.final_logp).astype(np.float32)
    mass = np.full(S_lm, 0.0)
    np.add.at(mass, eg, np.exp(initial.astype(np.float64)))
    lm_initial = np.log(np.maximum(mass, 1e-30)).astype(np.float32)

    log.info("den graph (left-biphone): %d lm states → %d (lm, left) "
             "states, %d arcs", S_lm, S, len(src))
    return DenominatorGraph(
        num_states=S, src=src, dst=dst, pdf=pdf, logw=logw,
        initial=initial, final=final, lm=lm,
        l_self=l_self.astype(np.float32), l_fwd=l_fwd.astype(np.float32),
        state_self_pdf=st_self.astype(np.int32),
        state_entry_pdf=st_entry.astype(np.int32),
        lm_initial=lm_initial, lm_l_self=lm_l_self.astype(np.float32),
        lm_l_fwd=lm_l_fwd.astype(np.float32), lm_final=lm_final,
        exp_index=exp_index)


# ---------------------------------------------------------------------------
# Denominator forward (log Z)
# ---------------------------------------------------------------------------

def _segment_logsumexp(vals: jnp.ndarray, segs: jnp.ndarray,
                       num_segments: int) -> jnp.ndarray:
    """logsumexp of vals grouped by segs along the last axis.
    vals: (..., A); segs: (A,). Returns (..., num_segments)."""
    NEG = jnp.float32(-1e30)
    mx = jnp.full(vals.shape[:-1] + (num_segments,), NEG)
    mx = mx.at[..., segs].max(vals)
    mx_g = mx[..., segs]
    s = jnp.zeros(vals.shape[:-1] + (num_segments,))
    s = s.at[..., segs].add(jnp.exp(vals - mx_g))
    return mx + jnp.log(jnp.maximum(s, 1e-30))


def denominator_logprob(den: DenominatorGraph, scores: jnp.ndarray,
                        mask: Optional[jnp.ndarray] = None,
                        leaky_hmm_coefficient: float = 0.0,
                        dense_state_limit: int = 4096) -> jnp.ndarray:
    """log Z of the denominator HMM for each sequence.

    scores: (B, T, num_pdfs) un-normalized log acoustic scores.
    mask: optional (B, T) bool — padded frames freeze alpha, so the
    denominator integrates exactly the frames the numerator sees.
    leaky_hmm_coefficient: per-frame leak to the stationary
    distribution (chain-denominator.h's leaky-HMM — gradually forgets
    context, bounding occupancies and stabilizing training).
    Returns (B,) log-probs.  Differentiable; wrap calls in
    jax.value_and_grad.

    Recursion: a chain den graph's arc pdf is a function of the
    DESTINATION state (entry arcs into d emit d's forward pdf,
    self-loops d's self pdf), so the per-frame expansion factorizes
    into one dense (B,S)×(S,S) matmul over the entry-transition
    matrix plus an elementwise self-loop term — matrix-unit work
    instead of A-sized scatters (the scatter formulation is kept as
    the oracle; their relative cost on the GPU is unmeasured).  Above
    ``dense_state_limit`` states the (S,S) matrix outgrows device
    memory sanity and the scatter path is used.
    """
    S = den.num_states
    src = jnp.asarray(den.src)
    dst = jnp.asarray(den.dst)
    pdf = jnp.asarray(den.pdf)
    logw = jnp.asarray(den.logw)
    initial = jnp.asarray(den.initial)
    final = jnp.asarray(den.final)

    B, T, _ = scores.shape
    if mask is None:
        mask = jnp.ones((B, T), bool)

    # Frame 0: a chunk may start mid-phone (state p continuing → emits
    # p's self-loop pdf) OR at a phone start (entering p → emits p's
    # forward/entry pdf).  Both options must be in the denominator or the
    # numerator's chunk-start forward pdfs escape normalization and the
    # objective grows without bound.
    if den.state_self_pdf is not None:
        self_pdf_np = np.asarray(den.state_self_pdf, np.int32)
        entry_pdf_np = np.asarray(den.state_entry_pdf, np.int32)
    else:                   # legacy graphs: infer (heuristic)
        self_pdf_np = np.zeros(S, np.int32)
        entry_pdf_np = np.zeros(S, np.int32)
        best_w = np.full(S, -np.inf)
        for a in range(len(den.src)):
            s, d = den.src[a], den.dst[a]
            if s == d and den.logw[a] > best_w[s]:
                best_w[s] = den.logw[a]
                self_pdf_np[s] = den.pdf[a]
            if s != d:
                entry_pdf_np[d] = den.pdf[a]
    self_pdf = jnp.asarray(self_pdf_np)
    entry_pdf = jnp.asarray(entry_pdf_np)

    if leaky_hmm_coefficient > 0.0:
        log_leak = jnp.float32(math.log(leaky_hmm_coefficient))

        def leak(alpha):
            tot = jax.scipy.special.logsumexp(alpha, axis=1, keepdims=True)
            return jnp.logaddexp(alpha, log_leak + initial[None, :] + tot)
    else:
        def leak(alpha):
            return alpha

    use_dense = S <= dense_state_limit
    if use_dense:
        # hoist the per-state pdf score lookups OUT of the scan: one
        # (B, T, S) gather batched over all frames instead of two
        # (B, S) gathers per scan step (xplane: the in-scan gathers +
        # their backward scatters were ~70 µs/frame — the dominant
        # cost of the whole training step; the hoisted form is one
        # large op whose backward is one batched scatter-add)
        self_sc = scores[:, :, self_pdf]       # (B, T, S)
        entry_sc = scores[:, :, entry_pdf]     # (B, T, S)
        alpha0 = leak(initial[None, :]
                      + jnp.logaddexp(self_sc[:, 0], entry_sc[:, 0]))
    else:
        alpha0 = leak(initial[None, :] + jnp.logaddexp(
            scores[:, 0, :][:, self_pdf],
            scores[:, 0, :][:, entry_pdf]))    # (B, S)
    if use_dense:
        # dense entry-transition matrix W[s, d] = Σ exp(logw) over
        # s→d arcs (self-loops excluded: they ride the elementwise
        # term); summed self-loop weight per state
        W_np = np.zeros((S, S), np.float64)
        l_self_np = np.full(S, -np.inf)
        for a in range(len(den.src)):
            s_, d_ = int(den.src[a]), int(den.dst[a])
            if s_ == d_ and int(den.pdf[a]) == int(self_pdf_np[s_]):
                # true HMM self-loop (s==d arcs emitting the ENTRY pdf
                # are LM re-entries of the same phone → entry matrix)
                l_self_np[s_] = np.logaddexp(l_self_np[s_],
                                             den.logw[a])
            else:
                W_np[s_, d_] += math.exp(float(den.logw[a]))
        W_dense = jnp.asarray(W_np, jnp.float32)
        l_self = jnp.asarray(l_self_np, jnp.float32)

    if use_dense:
        # (alternatives: per-frame in-scan gathers instead of the
        # hoisted (B,T,S) gathers, scan unrolling, and the
        # reference-style LINEAR-space rescaled recursion — one
        # multiply + matmul + normalize per frame.  The step is bound
        # by the (B,S) recurrent dependency, so the log-space form is
        # kept for its numerics; the ranking is unmeasured on the GPU.)
        # NO jax.checkpoint here: the scan's stored carries are only
        # T×(B,S) ≈ 10 MB at bench shapes, and rematerializing the
        # forward in the backward pass re-runs the whole latency-bound
        # scan a second time (the sparse path below keeps checkpoint —
        # its states exceed dense_state_limit, so memory matters there)
        def step_dense(alpha, self_t, entry_t):
            # α'[d] = logaddexp(α[d] + l_self[d] + self_t[d],
            #                   log(Σ_s e^{α[s]} W[s,d]) + entry_t[d])
            m0 = jnp.max(alpha, axis=1, keepdims=True)
            p = jnp.exp(alpha - m0)
            entry = m0 + jnp.log(jnp.maximum(
                jnp.dot(p, W_dense,
                        precision=jax.lax.Precision.HIGHEST), 1e-30))
            new_alpha = leak(jnp.logaddexp(
                alpha + l_self[None, :] + self_t, entry + entry_t))
            # normalize for stability; carry the log-correction
            m = jnp.max(new_alpha, axis=1, keepdims=True)
            return new_alpha - m, m[:, 0]

        def scan_step(carry, xs):
            self_t, entry_t, act = xs
            alpha, corr = carry
            new_alpha, m = step_dense(alpha, self_t, entry_t)
            # padded frames: freeze alpha and the correction
            new_alpha = jnp.where(act[:, None], new_alpha, alpha)
            corr = corr + jnp.where(act, m, 0.0)
            return (new_alpha, corr), None

        xs = (jnp.swapaxes(self_sc[:, 1:], 0, 1),
              jnp.swapaxes(entry_sc[:, 1:], 0, 1),
              jnp.swapaxes(mask[:, 1:], 0, 1))
        (alphaT, corr), _ = jax.lax.scan(scan_step, (alpha0,
                                                     jnp.zeros(B)), xs)
        return corr + jax.scipy.special.logsumexp(
            alphaT + final[None, :], axis=1)

    @jax.checkpoint
    def step_sparse(alpha, score_t):
        contrib = alpha[:, src] + logw[None, :] + score_t[:, pdf]
        new_alpha = leak(_segment_logsumexp(contrib, dst, S))
        m = jnp.max(new_alpha, axis=1, keepdims=True)
        return new_alpha - m, m[:, 0]

    def scan_step(carry, xs):
        score_t, act = xs
        alpha, corr = carry
        new_alpha, m = step_sparse(alpha, score_t)
        new_alpha = jnp.where(act[:, None], new_alpha, alpha)
        corr = corr + jnp.where(act, m, 0.0)
        return (new_alpha, corr), None

    xs = (jnp.swapaxes(scores[:, 1:, :], 0, 1),
          jnp.swapaxes(mask[:, 1:], 0, 1))
    (alphaT, corr), _ = jax.lax.scan(scan_step, (alpha0, jnp.zeros(B)),
                                     xs)
    return corr + jax.scipy.special.logsumexp(alphaT + final[None, :], axis=1)


def numpy_den_forward(den: DenominatorGraph, scores: np.ndarray,
                      ) -> np.ndarray:
    """Float64 NumPy forward of the denominator HMM — the plain
    reference denominator_logprob is checked against.  Arc by arc: each
    arc adds its own weight and its own pdf's score (no factorization
    by destination state); frame 0 allows both a state's self-loop pdf
    and its entry pdf, as denominator_logprob does.  (B, T, P) scores →
    (B,) log Z, no leaky HMM."""
    scores = np.asarray(scores, np.float64)
    B, T, _ = scores.shape
    S = den.num_states
    src = np.asarray(den.src)
    dst = np.asarray(den.dst)
    pdf = np.asarray(den.pdf)
    logw = np.asarray(den.logw, np.float64)
    if den.state_self_pdf is not None:
        self_pdf = np.asarray(den.state_self_pdf)
        entry_pdf = np.asarray(den.state_entry_pdf)
    else:
        self_pdf = np.zeros(S, np.int64)
        entry_pdf = np.zeros(S, np.int64)
        loops = src == dst
        self_pdf[src[loops]] = pdf[loops]
        entry_pdf[dst[~loops]] = pdf[~loops]
    out = np.zeros(B)
    for b in range(B):
        alpha = np.asarray(den.initial, np.float64) + np.logaddexp(
            scores[b, 0, self_pdf], scores[b, 0, entry_pdf])
        for t in range(1, T):
            contrib = alpha[src] + logw + scores[b, t, pdf]
            m = np.full(S, -np.inf)
            np.maximum.at(m, dst, contrib)
            safe = np.where(np.isfinite(m), m, 0.0)
            tot = np.zeros(S)
            np.add.at(tot, dst, np.exp(contrib - safe[dst]))
            with np.errstate(divide="ignore"):
                alpha = np.where(np.isfinite(m), safe + np.log(tot),
                                 -np.inf)
        out[b] = np.logaddexp.reduce(alpha + np.asarray(den.final,
                                                        np.float64))
    return out


# ---------------------------------------------------------------------------
# Numerators
# ---------------------------------------------------------------------------

def numerator_logprob(scores: jnp.ndarray, pdf_ali: jnp.ndarray,
                      mask: jnp.ndarray) -> jnp.ndarray:
    """Fixed-path numerator: Σ_t scores[t, pdf_ali[t]] over valid frames.
    scores: (B, T, P); pdf_ali: (B, T) int32; mask: (B, T) bool."""
    B, T, P = scores.shape
    gathered = jnp.take_along_axis(
        scores, pdf_ali[..., None].astype(jnp.int32), axis=2)[..., 0]
    return jnp.sum(jnp.where(mask, gathered, 0.0), axis=1)


def numerator_flexible_logprob(scores: jnp.ndarray,
                               entry_pdf: jnp.ndarray,
                               self_pdf: jnp.ndarray,
                               num_segs: jnp.ndarray,
                               mask: jnp.ndarray,
                               entry_w: Optional[jnp.ndarray] = None,
                               self_w: Optional[jnp.ndarray] = None,
                               init_w: Optional[jnp.ndarray] = None,
                               final_w: Optional[jnp.ndarray] = None
                               ) -> jnp.ndarray:
    """Supervision-FST numerator with FREE phone-boundary placement
    (a superset of chain-supervision.h's ±tolerance window): the chunk's
    phone-segment sequence is fixed, but frames distribute over segments
    arbitrarily (each segment ≥ 1 frame).

    The supervision graph is a linear chain over segments, so the
    forward recursion is shift + logaddexp — no gathers:

        α'[s] = logaddexp(α[s] + score[self_pdf[s]] + self_w[s],
                          α[s−1] + score[entry_pdf[s]] + entry_w[s])

    The optional weights are the NORMALIZATION-FST composition
    (chain-supervision.h AddWeightToSupervisionFst): entry_w carries
    log p_fwd + log p_LM(phone_s | history) per segment, self_w carries
    log p_self, init_w/final_w the den graph's initial/final log-probs
    of the first/last segment's state — making num − den a properly
    normalized (≤ 0) log-likelihood ratio.

    scores (B, T, P); entry_pdf/self_pdf (B, S) padded; num_segs (B,);
    mask (B, T).  Frame 0 admits entry OR continuation of segment 0
    (chunks may start mid-phone).  Returns (B,) log-probs.
    """
    B, T, P = scores.shape
    S = entry_pdf.shape[1]
    NEG = jnp.float32(-1e30)
    if entry_w is None:
        entry_w = jnp.zeros((B, S), jnp.float32)
    if self_w is None:
        self_w = jnp.zeros((B, S), jnp.float32)
    if init_w is None:
        init_w = jnp.zeros((B,), jnp.float32)
    if final_w is None:
        final_w = jnp.zeros((B,), jnp.float32)

    # hoisted (B, T, S) pdf-score lookups — one batched gather instead
    # of two (B, S) gathers per scan step (see denominator_logprob)
    self_sc = jnp.take_along_axis(
        scores, jnp.broadcast_to(self_pdf[:, None, :], (B, T, S)),
        axis=2)
    entry_sc = jnp.take_along_axis(
        scores, jnp.broadcast_to(entry_pdf[:, None, :], (B, T, S)),
        axis=2)
    alpha0 = jnp.full((B, S), NEG).at[:, 0].set(
        init_w + jnp.logaddexp(entry_sc[:, 0, 0], self_sc[:, 0, 0]))

    def step(alpha, xs):
        self_t, entry_t, act = xs
        stay = alpha + self_t + self_w
        shifted = jnp.concatenate(
            [jnp.full((B, 1), NEG), (alpha + entry_w_shift)[:, :-1]], axis=1)
        advance = shifted + entry_t
        new = jnp.logaddexp(stay, advance)
        new = jnp.where(act[:, None], new, alpha)
        return new, None

    # entering segment s from s-1 pays entry_w[s]; align it for the shift
    entry_w_shift = jnp.concatenate(
        [entry_w[:, 1:], jnp.zeros((B, 1), jnp.float32)], axis=1)

    alpha, _ = jax.lax.scan(
        step, alpha0,
        (jnp.swapaxes(self_sc[:, 1:], 0, 1),
         jnp.swapaxes(entry_sc[:, 1:], 0, 1),
         jnp.swapaxes(mask[:, 1:], 0, 1)))
    # end in the LAST segment (it may continue past the chunk edge)
    last = jnp.clip(num_segs - 1, 0, S - 1)
    return final_w + jnp.take_along_axis(
        alpha, last[:, None].astype(jnp.int32), axis=1)[:, 0]


@dataclasses.dataclass
class ChainTrainingOptions:
    """Mirrors chain-training.h ChainTrainingOptions names."""
    l2_regularize: float = 5e-5
    leaky_hmm_coefficient: float = 0.1
    xent_regularize: float = 0.0


def chain_objf(den: DenominatorGraph, scores: jnp.ndarray,
               pdf_ali: jnp.ndarray, mask: jnp.ndarray,
               opts: ChainTrainingOptions = ChainTrainingOptions(),
               num_graph: Optional[Tuple[jnp.ndarray, ...]] = None,
               num_fsa: Optional[Tuple] = None
               ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Negative LF-MMI objective per frame (to minimize) + diagnostics.

    num_graph = (entry_pdf, self_pdf, num_segs[, entry_w, self_w,
    init_w, final_w]) switches the numerator to the flexible-boundary
    supervision FST (optionally normalization-weighted); pdf_ali is
    ignored then.  num_fsa = (packed supervision dict, tolerance)
    switches to the lattice-derived supervision FSA
    (am/chain_supervision.py) and takes precedence."""
    if num_fsa is not None:
        from kaldi_tpu.am.chain_supervision import numerator_fsa_logprob
        num = numerator_fsa_logprob(scores, num_fsa[0],
                                    tolerance=num_fsa[1])
    elif num_graph is not None:
        num = numerator_flexible_logprob(
            scores, num_graph[0], num_graph[1], num_graph[2], mask,
            *num_graph[3:])
    else:
        num = numerator_logprob(scores, pdf_ali, mask)
    den_lp = denominator_logprob(
        den, scores, mask=mask,
        leaky_hmm_coefficient=opts.leaky_hmm_coefficient)
    num_frames = jnp.maximum(jnp.sum(mask), 1)
    objf = (jnp.sum(num) - jnp.sum(den_lp)) / num_frames
    loss = -objf
    if opts.l2_regularize > 0:
        loss = loss + opts.l2_regularize * jnp.mean(scores ** 2)
    return loss, {"objf": objf, "num": jnp.sum(num) / num_frames,
                  "den": jnp.sum(den_lp) / num_frames}


# ---------------------------------------------------------------------------
# PhoneLm serialization (chain-est-phone-lm output artifact)
# ---------------------------------------------------------------------------

def write_phone_lm(path: str, lm: PhoneLm) -> None:
    """Kaldi-style binary serialization of the denominator phone LM
    (the chain-est-phone-lm stage artifact — ref writes a phone-level
    G FST; the dense-row form here is the same model in the layout
    make_denominator_graph consumes)."""
    from kaldi_tpu.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<PhoneLm>")
        kio.write_basic_int32(f, lm.order)
        kio.write_int_vector(f, np.asarray(lm.phones, np.int32))
        kio.write_basic_int32(f, len(lm.hists))
        for h in lm.hists:
            kio.write_int_vector(f, np.asarray(h, np.int32))
        kio.write_matrix(f, lm.next_logp.astype(np.float32))
        kio.write_vector(f, lm.final_logp.astype(np.float32))
        kio.write_matrix(f, lm.next_state.astype(np.float32))
        kio.write_token(f, "</PhoneLm>")


def read_phone_lm(path: str) -> PhoneLm:
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<PhoneLm>")
        order = kio.read_basic_int32(f)
        phones = [int(x) for x in kio.read_int_vector(f)]
        nh = kio.read_basic_int32(f)
        hists = [tuple(int(x) for x in kio.read_int_vector(f))
                 for _ in range(nh)]
        next_logp = kio.read_matrix(f).astype(np.float64)
        final_logp = np.asarray(kio.read_vector(f), np.float64)
        next_state = kio.read_matrix(f).astype(np.int32)
        kio.expect_token(f, "</PhoneLm>")
        return PhoneLm(order=order, phones=phones, hists=hists,
                       next_logp=next_logp, final_logp=final_logp,
                       next_state=next_state)


def write_denominator_graph(f, den: DenominatorGraph) -> None:
    """Serialize the den graph (chainbin/nnet3-chain-make-den-fst
    writes den.fst + normalization.fst; here one file carries the flat
    arc arrays plus the stationary-distribution initial probs and the
    per-state topology log-probs the normalization weights need)."""
    from kaldi_tpu.am.serialize import write_pytree
    from kaldi_tpu.core import io as kio
    kio.write_token(f, "<DenGraph>")
    d = {"num_states": np.int32(den.num_states), "src": den.src,
         "dst": den.dst, "pdf": den.pdf, "logw": den.logw,
         "initial": den.initial, "final": den.final}
    if den.l_self is not None:
        d["l_self"] = den.l_self
        d["l_fwd"] = den.l_fwd
    if den.state_self_pdf is not None:
        d["state_self_pdf"] = den.state_self_pdf
        d["state_entry_pdf"] = den.state_entry_pdf
    if den.lm is not None:
        lm = den.lm
        hist_flat = np.asarray([p for h in lm.hists for p in h],
                               np.int32)
        hist_len = np.asarray([len(h) for h in lm.hists], np.int32)
        d["lm_order"] = np.int32(lm.order)
        d["lm_phones"] = np.asarray(lm.phones, np.int32)
        d["lm_hist_flat"] = hist_flat
        d["lm_hist_len"] = hist_len
        d["lm_next_logp"] = lm.next_logp
        d["lm_final_logp"] = lm.final_logp
        d["lm_next_state"] = lm.next_state
    write_pytree(f, d)
    kio.write_token(f, "</DenGraph>")


def read_denominator_graph(f) -> DenominatorGraph:
    from kaldi_tpu.am.serialize import read_pytree
    from kaldi_tpu.core import io as kio
    kio.expect_token(f, "<DenGraph>")
    d = read_pytree(f)
    kio.expect_token(f, "</DenGraph>")
    lm = None
    if "lm_order" in d:
        hists, pos = [], 0
        flat = d["lm_hist_flat"].astype(np.int32)
        for n in d["lm_hist_len"].astype(np.int32):
            hists.append(tuple(int(p) for p in flat[pos:pos + n]))
            pos += n
        lm = PhoneLm(order=int(d["lm_order"]),
                     phones=[int(p) for p in d["lm_phones"]],
                     hists=hists,
                     next_logp=d["lm_next_logp"].astype(np.float32),
                     final_logp=d["lm_final_logp"].astype(np.float32),
                     next_state=d["lm_next_state"].astype(np.int32))
    return DenominatorGraph(
        lm=lm,
        num_states=int(d["num_states"]),
        src=d["src"].astype(np.int32), dst=d["dst"].astype(np.int32),
        pdf=d["pdf"].astype(np.int32), logw=d["logw"].astype(np.float32),
        initial=d["initial"].astype(np.float32),
        final=d["final"].astype(np.float32),
        l_self=(d["l_self"].astype(np.float32)
                if "l_self" in d else None),
        l_fwd=(d["l_fwd"].astype(np.float32) if "l_fwd" in d else None),
        state_self_pdf=(d["state_self_pdf"].astype(np.int32)
                        if "state_self_pdf" in d else None),
        state_entry_pdf=(d["state_entry_pdf"].astype(np.int32)
                         if "state_entry_pdf" in d else None))
