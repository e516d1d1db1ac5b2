"""Batched exact Viterbi forced alignment on device.

Parity target: src/gmmbin/gmm-align-compiled.cc (FasterDecoder over a
per-utterance training graph).  Training graphs are tiny (linear
transcripts), so instead of beam-pruned token passing we run *exact*
dense Viterbi with the same formulation as decoder/dense.py:
arcs packed by DESTINATION state so recombination is a gather +
min-reduce (no scatters), the ε-closure a fixed
number of sweeps, and the backtrace a reverse lax.scan on device so
only (T,)-sized tid arrays leave the chip.

A whole minibatch of utterances aligns in one vmapped scan — the device
replacement for Kaldi's nj×utterance process fan-out (SURVEY.md §2.4).
Graphs are passed as padded dense tensors (not closed-over constants)
so ONE compilation per (S, A, E, T) bucket serves every utterance and
iteration.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.fst.fst import EPS, VectorFst

log = get_logger(__name__)

BIG = jnp.float32(1e30)


@dataclasses.dataclass
class DenseGraph:
    """Padded dense arc tensors for one graph, grouped by SOURCE state
    (used by lattice β recursions) — see pack_dense."""
    num_states: int
    start: int
    e_il: np.ndarray      # (S, Ae) int32, 0-padded
    e_ol: np.ndarray      # (S, Ae) int32 output labels
    e_w: np.ndarray       # (S, Ae) f32, BIG-padded
    e_ns: np.ndarray      # (S, Ae) int32
    n_ol: np.ndarray      # (S, An) int32 output labels
    n_w: np.ndarray       # (S, An) f32, BIG-padded
    n_ns: np.ndarray      # (S, An) int32
    final: np.ndarray     # (S,) f32
    eps_depth: int


@dataclasses.dataclass
class DenseRGraph:
    """Arcs grouped by DESTINATION (the aligner/decoder fast path)."""
    num_states: int
    start: int
    e_src: np.ndarray     # (S, Ae) int32
    e_il: np.ndarray      # (S, Ae) int32
    e_w: np.ndarray       # (S, Ae) f32 BIG-padded
    n_src: np.ndarray     # (S, An) int32
    n_w: np.ndarray       # (S, An) f32 BIG-padded
    final: np.ndarray     # (S,) f32
    eps_depth: int


def pack_dense(fst: VectorFst, s_pad: int, ae_pad: int, an_pad: int
               ) -> DenseGraph:
    from kaldi_tpu.fst.csr import _eps_depth
    S = fst.num_states
    if S > s_pad:
        raise KaldiError(f"pack_dense: {S} states > pad {s_pad}")
    e_il = np.zeros((s_pad, ae_pad), np.int32)
    e_ol = np.zeros((s_pad, ae_pad), np.int32)
    e_w = np.full((s_pad, ae_pad), 1e30, np.float32)
    e_ns = np.zeros((s_pad, ae_pad), np.int32)
    n_ol = np.zeros((s_pad, an_pad), np.int32)
    n_w = np.full((s_pad, an_pad), 1e30, np.float32)
    n_ns = np.zeros((s_pad, an_pad), np.int32)
    final = np.full(s_pad, 1e30, np.float32)
    n_off = np.zeros(S + 1, np.int64)
    n_ns_flat = []
    for s in range(S):
        ei = ni = 0
        n_off[s] = len(n_ns_flat)
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                if ei >= ae_pad:
                    raise KaldiError("pack_dense: emit degree overflow")
                e_il[s, ei] = a.ilabel
                e_ol[s, ei] = a.olabel
                e_w[s, ei] = a.weight
                e_ns[s, ei] = a.nextstate
                ei += 1
            else:
                if ni >= an_pad:
                    raise KaldiError("pack_dense: eps degree overflow")
                n_ol[s, ni] = a.olabel
                n_w[s, ni] = a.weight
                n_ns[s, ni] = a.nextstate
                ni += 1
                n_ns_flat.append(a.nextstate)
    n_off[S] = len(n_ns_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_ns_flat, np.int64))
    for s, w in fst.finals.items():
        final[s] = w
    return DenseGraph(S, fst.start, e_il, e_ol, e_w, e_ns, n_ol, n_w,
                      n_ns, final, depth)


def pack_dense_reverse(fst: VectorFst, s_pad: int, ae_pad: int, an_pad: int
                       ) -> DenseRGraph:
    from kaldi_tpu.fst.csr import _eps_depth
    S = fst.num_states
    if S > s_pad:
        raise KaldiError(f"pack_dense_reverse: {S} states > pad {s_pad}")
    e_src = np.zeros((s_pad, ae_pad), np.int32)
    e_il = np.zeros((s_pad, ae_pad), np.int32)
    e_w = np.full((s_pad, ae_pad), 1e30, np.float32)
    n_src = np.zeros((s_pad, an_pad), np.int32)
    n_w = np.full((s_pad, an_pad), 1e30, np.float32)
    final = np.full(s_pad, 1e30, np.float32)
    e_cnt = np.zeros(s_pad, np.int64)
    n_cnt = np.zeros(s_pad, np.int64)
    n_off = np.zeros(S + 1, np.int64)
    n_flat = []
    for s in range(S):
        n_off[s] = len(n_flat)
        for a in fst.arcs[s]:
            d = a.nextstate
            if a.ilabel != EPS:
                k = e_cnt[d]
                if k >= ae_pad:
                    raise KaldiError("pack_dense_reverse: in-degree overflow")
                e_src[d, k] = s
                e_il[d, k] = a.ilabel
                e_w[d, k] = a.weight
                e_cnt[d] += 1
            else:
                k = n_cnt[d]
                if k >= an_pad:
                    raise KaldiError("pack_dense_reverse: eps in-degree "
                                     "overflow")
                n_src[d, k] = s
                n_w[d, k] = a.weight
                n_cnt[d] += 1
                n_flat.append(d)
    n_off[S] = len(n_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_flat, np.int64))
    for s, w in fst.finals.items():
        final[s] = w
    return DenseRGraph(S, fst.start, e_src, e_il, e_w, n_src, n_w, final,
                       depth)


def degrees(fst: VectorFst) -> Tuple[int, int]:
    """Max OUT-degrees (emitting, eps)."""
    ae = an = 0
    for arcs in fst.arcs:
        e = sum(1 for a in arcs if a.ilabel != EPS)
        n = len(arcs) - e
        ae, an = max(ae, e), max(an, n)
    return ae, an


def in_degrees(fst: VectorFst) -> Tuple[int, int]:
    """Max IN-degrees (emitting, eps)."""
    e = np.zeros(fst.num_states, np.int64)
    n = np.zeros(fst.num_states, np.int64)
    for arcs in fst.arcs:
        for a in arcs:
            if a.ilabel != EPS:
                e[a.nextstate] += 1
            else:
                n[a.nextstate] += 1
    return int(e.max(initial=0)), int(n.max(initial=0))


def _round_up(x: int, m: int = 8) -> int:
    return ((max(x, 1) + m - 1) // m) * m


class DenseAligner:
    """One jitted align function per (S, Ae, An, E, T, P) bucket."""

    def __init__(self, tid_to_pdf: np.ndarray, acoustic_scale: float = 1.0):
        self.tid2pdf = jnp.asarray(tid_to_pdf, jnp.int32)
        self.acoustic_scale = acoustic_scale
        self._jits = {}

    # -- device code -------------------------------------------------------
    def _align_one(self, E: int, g, loglikes, num_frames):
        e_src, e_il, e_w, n_src, n_w, final, start = g
        S, Ae = e_src.shape
        scale = self.acoustic_scale
        e_pdf = self.tid2pdf[e_il]

        def eps_sweep(alpha):
            cand = alpha[n_src] + n_w
            best = jnp.min(cand, axis=1)
            arg = jnp.argmin(cand, axis=1).astype(jnp.int32)
            keep = alpha <= best
            return jnp.minimum(alpha, best), jnp.where(keep, -1, arg)

        def frame_step(alpha, xs):
            loglike, act = xs
            ac = -scale * loglike[e_pdf]
            cand = alpha[e_src] + e_w + ac
            new = jnp.min(cand, axis=1)
            bp_e = jnp.argmin(cand, axis=1).astype(jnp.int32)
            bps = [bp_e]
            for _ in range(E):
                new, bp = eps_sweep(new)
                bps.append(bp)
            new = jnp.where(act, new, alpha)
            bps = [jnp.where(act, b, -1) for b in bps]
            return new, jnp.stack(bps)

        alpha0 = jnp.full((S,), BIG).at[start].set(0.0)
        for _ in range(E):
            alpha0, _ = eps_sweep(alpha0)
        T_pad = loglikes.shape[0]
        active = jnp.arange(T_pad) < num_frames
        alpha, bps = jax.lax.scan(frame_step, alpha0, (loglikes, active))
        total = alpha + final
        best_state = jnp.argmin(total).astype(jnp.int32)

        def bt_step(s, xs):
            bp_t, act = xs
            for e in range(E, 0, -1):
                slot = bp_t[e, s]
                take = (slot >= 0) & act
                s = jnp.where(take, n_src[s, jnp.maximum(slot, 0)], s)
            slot0 = jnp.maximum(bp_t[0, s], 0)
            tid = jnp.where(act, e_il[s, slot0], 0)
            prev = jnp.where(act, e_src[s, slot0], s)
            return prev, tid

        _, tids = jax.lax.scan(bt_step, best_state, (bps, active),
                               reverse=True)
        return {"tids": tids, "best_cost": total[best_state]}

    # -- host API ----------------------------------------------------------
    def align_batch(self, graphs: Sequence[DenseRGraph],
                    loglikes_list: Sequence[np.ndarray]
                    ) -> List[Tuple[List[int], float]]:
        """Align a batch; graphs are padded to a shared bucket here."""
        B = len(graphs)
        S = _round_up(max(g.e_src.shape[0] for g in graphs))
        Ae = max(g.e_src.shape[1] for g in graphs)
        An = max(max(g.n_src.shape[1] for g in graphs), 1)
        E = max(g.eps_depth for g in graphs)
        T = _round_up(max(l.shape[0] for l in loglikes_list), 16)

        def pad_graph(g: DenseRGraph):
            e_src = np.zeros((S, Ae), np.int32)
            e_src[:g.e_src.shape[0], :g.e_src.shape[1]] = g.e_src
            e_il = np.zeros((S, Ae), np.int32)
            e_il[:g.e_il.shape[0], :g.e_il.shape[1]] = g.e_il
            e_w = np.full((S, Ae), 1e30, np.float32)
            e_w[:g.e_w.shape[0], :g.e_w.shape[1]] = g.e_w
            n_src = np.zeros((S, An), np.int32)
            n_src[:g.n_src.shape[0], :g.n_src.shape[1]] = g.n_src
            n_w = np.full((S, An), 1e30, np.float32)
            n_w[:g.n_w.shape[0], :g.n_w.shape[1]] = g.n_w
            final = np.full(S, 1e30, np.float32)
            final[:len(g.final)] = g.final
            return (e_src, e_il, e_w, n_src, n_w, final, np.int32(g.start))

        P = loglikes_list[0].shape[1]
        lls = np.zeros((B, T, P), np.float32)
        lens = np.zeros(B, np.int32)
        for b, l in enumerate(loglikes_list):
            lls[b, :l.shape[0]] = l
            lens[b] = l.shape[0]
        batch = [pad_graph(g) for g in graphs]
        stacked = tuple(np.stack([bg[i] for bg in batch]) for i in range(7))

        key = (S, Ae, An, E, T, P)
        if key not in self._jits:
            fn = partial(self._align_one, E)
            self._jits[key] = jax.jit(jax.vmap(fn))
            log.info("DenseAligner: compiling bucket %s", key)
        out = self._jits[key](tuple(jnp.asarray(x) for x in stacked),
                              jnp.asarray(lls), jnp.asarray(lens))
        out = jax.tree_util.tree_map(np.asarray, out)

        results = []
        for b in range(B):
            T_b = int(lens[b])
            cost = float(out["best_cost"][b])
            if cost >= 1e29:
                raise KaldiError(f"align: no path for utterance {b}")
            tids = [int(t) for t in out["tids"][b][:T_b]]
            if any(t == 0 for t in tids):
                raise KaldiError("align: broken backpointer")
            results.append((tids, cost))
        return results
