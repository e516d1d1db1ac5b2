"""Dense gather-based Viterbi beam decoder.

A scatter-min token recombination lowers to scatters, which the
decoders here avoid by design (their GPU cost is unmeasured; ROADMAP
D2).  This decoder reformulates token
recombination as a GATHER: arcs are packed by *destination* state
(reverse adjacency, padded to the max in-degree), so

    alpha'[s] = min over incoming arcs a of
                alpha[src(a)] + w(a) − scale·loglike[pdf(ilabel(a))]

is a dense (S, Ain) gather + min-reduce — pure elementwise work, no scatters,
no sorts, no top-k.  Beam pruning is a vector mask against the frame
minimum.  This is exact Viterbi over the whole state space (max-active
= S), the right regime for small/medium graphs where dense per-state
arrays fit comfortably in HBM; the token-list decoder in beam.py
remains for graphs too large to keep dense.

Per-frame backpointers store the winning in-arc slot (one int8/int16
if Ain < 128, int32 here for simplicity) per state per ε-sweep.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.fst.fst import EPS, VectorFst

log = get_logger(__name__)

BIG = jnp.float32(1e30)


@dataclasses.dataclass
class ReverseDenseGraph:
    """Arcs grouped by destination, padded to max in-degree."""
    num_states: int
    start: int
    # emitting in-arcs: (S, Ae)
    e_src: np.ndarray
    e_il: np.ndarray
    e_ol: np.ndarray
    e_w: np.ndarray
    # epsilon in-arcs: (S, An)
    n_src: np.ndarray
    n_ol: np.ndarray
    n_w: np.ndarray
    final: np.ndarray          # (S,)
    eps_depth: int

    @property
    def max_in_emit(self) -> int:
        return self.e_src.shape[1]


def pack_reverse(fst: VectorFst) -> ReverseDenseGraph:
    from kaldi_tpu.fst.csr import _eps_depth
    S = fst.num_states
    if S == 0 or fst.start < 0:
        raise KaldiError("pack_reverse: empty FST")
    e_in: List[List[tuple]] = [[] for _ in range(S)]
    n_in: List[List[tuple]] = [[] for _ in range(S)]
    n_off = np.zeros(S + 1, np.int64)
    n_flat: List[int] = []
    for s in range(S):
        n_off[s] = len(n_flat)
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                e_in[a.nextstate].append((s, a.ilabel, a.olabel, a.weight))
            else:
                n_in[a.nextstate].append((s, a.olabel, a.weight))
                n_flat.append(a.nextstate)
    n_off[S] = len(n_flat)
    depth = _eps_depth(S, n_off, np.asarray(n_flat, np.int64))

    Ae = max(1, max(len(x) for x in e_in))
    An = max(1, max(len(x) for x in n_in))
    e_src = np.zeros((S, Ae), np.int32)
    e_il = np.zeros((S, Ae), np.int32)
    e_ol = np.zeros((S, Ae), np.int32)
    e_w = np.full((S, Ae), 1e30, np.float32)
    n_src = np.zeros((S, An), np.int32)
    n_ol = np.zeros((S, An), np.int32)
    n_w = np.full((S, An), 1e30, np.float32)
    for s in range(S):
        for i, (src, il, ol, w) in enumerate(e_in[s]):
            e_src[s, i] = src
            e_il[s, i] = il
            e_ol[s, i] = ol
            e_w[s, i] = w
        for i, (src, ol, w) in enumerate(n_in[s]):
            n_src[s, i] = src
            n_ol[s, i] = ol
            n_w[s, i] = w
    final = np.full(S, 1e30, np.float32)
    for s, w in fst.finals.items():
        final[s] = w
    return ReverseDenseGraph(S, fst.start, e_src, e_il, e_ol, e_w,
                             n_src, n_ol, n_w, final, depth)


@dataclasses.dataclass
class DenseDecoderConfig:
    beam: float = 16.0
    acoustic_scale: float = 0.1
    lattice_beam: float = 8.0       # used by decode_lattice


class DenseDecoder:
    """Exact dense Viterbi with beam masking; batch via vmap.

    Accepts either a prepacked ReverseDenseGraph or a VectorFst (the
    latter additionally enables lattice generation, which needs the
    source-grouped arc pack for the backward β recursion)."""

    def __init__(self, graph, tid_to_pdf: np.ndarray,
                 config: DenseDecoderConfig = None):
        self._fst = None
        if isinstance(graph, VectorFst):
            self._fst = graph
            graph = pack_reverse(graph)
        self.graph = graph
        self.tid_to_pdf = np.asarray(tid_to_pdf)
        self.config = config or DenseDecoderConfig()
        g = graph
        self.c = dict(
            e_src=jnp.asarray(g.e_src), e_il=jnp.asarray(g.e_il),
            e_w=jnp.asarray(g.e_w),
            n_src=jnp.asarray(g.n_src), n_w=jnp.asarray(g.n_w),
            final=jnp.asarray(g.final),
            e_pdf=jnp.asarray(tid_to_pdf, jnp.int32)[jnp.asarray(g.e_il)],
        )
        self._jit_one = jax.jit(self._decode_scan)
        self._jit_batch = jax.jit(jax.vmap(self._decode_scan,
                                           in_axes=(0, 0)))

    def _decode_scan(self, loglikes, num_frames):
        c = self.c
        S = self.graph.num_states
        E = self.graph.eps_depth
        beam = self.config.beam
        scale = self.config.acoustic_scale

        def eps_sweep(alpha):
            cand = alpha[c["n_src"]] + c["n_w"]            # (S, An)
            best = jnp.min(cand, axis=1)
            arg = jnp.argmin(cand, axis=1).astype(jnp.int32)
            keep = alpha <= best
            new = jnp.minimum(alpha, best)
            return new, jnp.where(keep, -1, arg)           # -1 = kept own

        def frame_step(alpha, xs):
            loglike, active = xs
            ac = -scale * loglike[c["e_pdf"]]              # (S, Ae)
            cand = alpha[c["e_src"]] + c["e_w"] + ac
            new = jnp.min(cand, axis=1)
            bp_e = jnp.argmin(cand, axis=1).astype(jnp.int32)
            # beam prune
            m = jnp.min(new)
            new = jnp.where(new > m + beam, BIG, new)
            bps = [bp_e]
            for _ in range(E):
                new, bp = eps_sweep(new)
                bps.append(bp)
            new = jnp.where(active, new, alpha)
            bps = [jnp.where(active, b, -1) for b in bps]
            return new, jnp.stack(bps)                     # (E+1, S)

        alpha0 = jnp.full((S,), BIG).at[self.graph.start].set(0.0)
        init_bps = []
        for _ in range(E):
            alpha0, bp = eps_sweep(alpha0)
            init_bps.append(bp)
        init_bps = (jnp.stack(init_bps) if init_bps
                    else jnp.zeros((0, S), jnp.int32))
        T_pad = loglikes.shape[0]
        active = jnp.arange(T_pad) < num_frames
        alpha, bps = jax.lax.scan(frame_step, alpha0, (loglikes, active))
        total = alpha + c["final"]
        has_final = jnp.min(total) < BIG
        use = jnp.where(has_final, total, alpha)
        best_state = jnp.argmin(use)

        # --- device backtrace: reverse scan over the (T, E+1, S) bps so
        # only (T,)-sized label arrays leave the chip (the (T, E+1, S)
        # table transfer dominated decode wall-clock otherwise).
        e_il = self.c["e_il"]
        e_ol_full = jnp.asarray(self.graph.e_ol)
        e_src_full = jnp.asarray(self.graph.e_src)
        n_ol_full = jnp.asarray(self.graph.n_ol)
        n_src_full = jnp.asarray(self.graph.n_src)

        def bt_step(s, xs):
            bp_t, act = xs                           # (E+1, S), bool
            ols = []
            for e in range(E, 0, -1):
                slot = bp_t[e, s]
                take = (slot >= 0) & act
                safe = jnp.maximum(slot, 0)
                ols.append(jnp.where(take, n_ol_full[s, safe], 0))
                s = jnp.where(take, n_src_full[s, safe], s)
            slot0 = jnp.maximum(bp_t[0, s], 0)
            tid = jnp.where(act, e_il[s, slot0], 0)
            ol0 = jnp.where(act, e_ol_full[s, slot0], 0)
            prev = jnp.where(act, e_src_full[s, slot0], s)
            # forward order within the frame: emit then sweeps 1..E
            ols_fwd = [ol0] + ols[::-1]
            return prev, (tid, jnp.stack(ols_fwd))

        s_end, (tids, ols) = jax.lax.scan(bt_step, best_state.astype(jnp.int32),
                                          (bps, active), reverse=True)
        # initial ε-closure olabels (before frame 0), walked backwards
        init_ols = []
        s0 = s_end
        for e in range(init_bps.shape[0] - 1, -1, -1):
            slot = init_bps[e, s0]
            take = slot >= 0
            safe = jnp.maximum(slot, 0)
            init_ols.append(jnp.where(take, n_ol_full[s0, safe], 0))
            s0 = jnp.where(take, n_src_full[s0, safe], s0)
        init_ols = (jnp.stack(init_ols[::-1]) if init_ols
                    else jnp.zeros((0,), jnp.int32))
        return {"tids": tids, "ols": ols, "init_ols": init_ols,
                "best_state": best_state, "best_cost": use[best_state]}

    # -- host API ----------------------------------------------------------
    def decode(self, loglikes: np.ndarray):
        T = loglikes.shape[0]
        out = self._jit_one(jnp.asarray(loglikes, jnp.float32), jnp.int32(T))
        return self._backtrace(jax.tree_util.tree_map(np.asarray, out), T)

    def decode_batch(self, loglikes_padded, num_frames):
        out = self._jit_batch(jnp.asarray(loglikes_padded, jnp.float32),
                              jnp.asarray(num_frames, jnp.int32))
        out = jax.tree_util.tree_map(np.asarray, out)
        return [self._backtrace(
            jax.tree_util.tree_map(lambda x: x[b], out),
            int(num_frames[b])) for b in range(loglikes_padded.shape[0])]

    def _backtrace(self, out, T: int):
        cost = float(out["best_cost"])
        if cost >= 1e29:
            raise KaldiError("DenseDecoder: no path")
        tids = [int(t) for t in out["tids"][:T]]
        if any(t == 0 for t in tids):
            raise KaldiError("DenseDecoder: broken backpointer")
        ols: List[int] = [int(o) for o in out["init_ols"] if o != 0]
        frame_ols = out["ols"][:T]               # (T, E+1), forward order
        nz = frame_ols.reshape(-1)
        ols.extend(int(o) for o in nz if o != 0)
        return tids, ols, cost

    # ------------------------------------------------------------------
    # Lattice generation (LatticeFasterDecoder::GetRawLattice equivalent)
    # ------------------------------------------------------------------

    def _ensure_lattice_jit(self):
        if getattr(self, "_lat_jit", None) is not None:
            return
        if self._fst is None:
            raise KaldiError("lattice generation needs a VectorFst-built "
                             "DenseDecoder")
        from kaldi_tpu.decoder.align import degrees, pack_dense
        ae, an = degrees(self._fst)
        fwd = pack_dense(self._fst, self._fst.num_states, max(ae, 1),
                         max(an, 1))
        self._fwd = fwd
        self._fwd_ols = fwd.e_ol
        self._fwd_eps_ols = fwd.n_ol
        f = dict(
            f_il=jnp.asarray(fwd.e_il), f_w=jnp.asarray(fwd.e_w),
            f_ns=jnp.asarray(fwd.e_ns),
            fn_w=jnp.asarray(fwd.n_w), fn_ns=jnp.asarray(fwd.n_ns),
            f_pdf=jnp.asarray(self.tid_to_pdf, jnp.int32)[
                jnp.asarray(fwd.e_il)],
        )
        c = self.c
        S = self.graph.num_states
        E = self.graph.eps_depth
        scale = self.config.acoustic_scale
        beam = self.config.beam

        def alpha_eps(alpha):
            for _ in range(E):
                cand = alpha[c["n_src"]] + c["n_w"]
                alpha = jnp.minimum(alpha, jnp.min(cand, axis=1))
            return alpha

        def beta_eps(beta):
            for _ in range(E):
                cand = f["fn_w"] + beta[f["fn_ns"]]
                beta = jnp.minimum(beta, jnp.min(cand, axis=1))
            return beta

        def alpha_compute(loglikes, num_frames):
            # frames ≥ num_frames are padding: pass α through unchanged
            def fstep(alpha, xs):
                loglike, act = xs
                ac = -scale * loglike[c["e_pdf"]]
                new = jnp.min(alpha[c["e_src"]] + c["e_w"] + ac, axis=1)
                m = jnp.min(new)
                new = jnp.where(new > m + beam, BIG, new)
                new = alpha_eps(new)
                new = jnp.where(act, new, alpha)
                return new, new

            alpha0 = alpha_eps(jnp.full((S,), BIG).at[self.graph.start]
                               .set(0.0))
            active = jnp.arange(loglikes.shape[0]) < num_frames
            _, alphas = jax.lax.scan(fstep, alpha0, (loglikes, active))
            return jnp.concatenate([alpha0[None], alphas])     # (T_pad+1, S)

        def beta_compute(loglikes, num_frames, final_vec):
            def bstep(beta_next, xs):
                loglike, act = xs
                ac = -scale * loglike[f["f_pdf"]]
                bemit = jnp.min(f["f_w"] + ac + beta_next[f["f_ns"]], axis=1)
                beta = beta_eps(bemit)
                beta = jnp.where(act, beta, beta_next)
                return beta, beta

            betaT = beta_eps(jnp.minimum(final_vec, BIG))
            active = jnp.arange(loglikes.shape[0]) < num_frames
            _, betas = jax.lax.scan(bstep, betaT, (loglikes, active),
                                    reverse=True)
            return jnp.concatenate([betas, betaT[None]])       # (T_pad+1, S)

        self._alpha_jit = jax.jit(alpha_compute)
        self._beta_jit = jax.jit(beta_compute)
        self._lat_jit = True

    def decode_lattice(self, loglikes: np.ndarray):
        """→ (Lattice raw, best cost).  Raw-lattice arcs are pruned by
        α(src) + arc + β(dst) ≤ best + lattice_beam — exactly the
        extra-cost criterion of PruneActiveTokens."""
        from kaldi_tpu.lattice.lattice import Lattice, LatticeArc
        self._ensure_lattice_jit()
        T = loglikes.shape[0]
        # bucket T so arbitrary lengths share compilations
        T_pad = ((T + 63) // 64) * 64
        loglikes = np.asarray(loglikes, np.float32)
        if T_pad != T:
            loglikes = np.concatenate(
                [loglikes, np.zeros((T_pad - T, loglikes.shape[1]),
                                    np.float32)])
        ll_dev = jnp.asarray(loglikes, jnp.float32)
        nf = jnp.int32(T)
        alphas = np.asarray(self._alpha_jit(ll_dev, nf))[:T + 1]
        final_np = np.asarray(self.graph.final)
        betas = np.asarray(self._beta_jit(
            ll_dev, nf, jnp.asarray(self.graph.final)))[:T + 1]
        use_final_probs = bool(
            np.min(alphas[T] + betas[T]) < 1e29)
        if not use_final_probs:
            # No beam-surviving token reaches a final state: fall back to
            # treating every live last-frame token as final with zero cost
            # (LatticeFasterDecoder use_final_probs=false behavior).
            betas = np.asarray(self._beta_jit(
                ll_dev, nf,
                jnp.zeros_like(jnp.asarray(self.graph.final))))[:T + 1]
            final_np = np.zeros_like(final_np)
        best = float(np.min(alphas[T] + betas[T]))
        if best >= 1e29:
            raise KaldiError("decode_lattice: no path")
        # f32 α/β accumulate rounding over T frames; widen the bound by a
        # magnitude-aware slack so the best path always survives.
        tol = 0.01 + 1e-5 * abs(best) + 1e-4 * T
        bound = best + self.config.lattice_beam + tol
        fwd = self._fwd
        S = self.graph.num_states
        keep = alphas + betas <= bound                         # (T+1, S)
        node_id = -np.ones((T + 1, S), np.int64)
        lat = Lattice()
        for t, s in zip(*np.nonzero(keep)):
            node_id[t, s] = lat.add_state()
        lat.start = int(node_id[0, self.graph.start])
        ll = np.asarray(loglikes)
        pdf_of = self.tid_to_pdf
        scale = self.config.acoustic_scale
        e_valid = fwd.e_w < 1e29                               # (S, Ae)
        n_valid = fwd.n_w < 1e29
        for t in range(T + 1):
            srcs = np.nonzero(keep[t])[0]
            if len(srcs) == 0:
                continue
            # emitting arcs t → t+1
            if t < T:
                ac_row = -scale * ll[t]
                for s in srcs:
                    a_src = int(node_id[t, s])
                    for k in np.nonzero(e_valid[s])[0]:
                        ns = int(fwd.e_ns[s, k])
                        if node_id[t + 1, ns] < 0:
                            continue
                        il = int(fwd.e_il[s, k])
                        w = float(fwd.e_w[s, k])
                        ac = float(ac_row[pdf_of[il]])
                        if (alphas[t, s] + w + ac + betas[t + 1, ns]
                                <= bound):
                            lat.arcs[a_src].append(LatticeArc(
                                il, int(self._fwd_olabel(s, k)), w, ac,
                                int(node_id[t + 1, ns])))
            # ε arcs within level t
            for s in srcs:
                a_src = int(node_id[t, s])
                for k in np.nonzero(n_valid[s])[0]:
                    ns = int(fwd.n_ns[s, k])
                    w = float(fwd.n_w[s, k])
                    if (alphas[t, s] + w + betas[t, ns] <= bound
                            and node_id[t, ns] >= 0):
                        lat.arcs[a_src].append(LatticeArc(
                            0, int(self._fwd_eps_olabel(s, k)), w, 0.0,
                            int(node_id[t, ns])))
        for s in np.nonzero(keep[T] & (final_np < 1e29))[0]:
            if alphas[T, s] + final_np[s] <= bound:
                lat.set_final(int(node_id[T, s]), float(final_np[s]), 0.0)
        return lat, best

    def _fwd_olabel(self, s: int, k: int) -> int:
        return self._fwd_ols[s, k]

    def _fwd_eps_olabel(self, s: int, k: int) -> int:
        return self._fwd_eps_ols[s, k]
