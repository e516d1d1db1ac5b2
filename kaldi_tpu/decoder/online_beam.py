"""Streaming large-graph decoding (LatticeFasterOnlineDecoder role).

Parity target: src/decoder/lattice-faster-online-decoder.h —
AdvanceDecoding() consumes score chunks as they arrive, BestPathEnd/
TraceBackBestPath give a partial result at ANY time, and GetLattice
at the end returns the determinized CompactLattice.  The reference's
online decoder is the offline one with incremental frame consumption;
same here: the chunk step reuses BeamDecoder._frame_step (the
sort-recombination sweep) with the token set CARRIED across chunks,
and appends to device-resident state:

  * backpointer buffers (max_frames, K) for prev-slot and arc-index —
    they stay in HBM; a partial traceback runs ON DEVICE (a while_loop
    over the filled prefix) and ships only the (max_frames,) winning
    arc-index path, exactly like the offline in-jit backtrace.
  * the same cursor-append record buffer the offline scan uses, so
    finalize() feeds the identical fused native
    build+determinize passes (GetRawLattice +
    DeterminizeLatticePhonePrunedWrapper).

Everything is fixed-shape: chunks are padded to `chunk_frames`, so one
compiled step serves the whole stream (the looped-computation
contract of decodable-online-looped.h).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.decoder.beam import BeamDecoder

log = get_logger(__name__)

INF = np.float32(np.inf)


class OnlineBeamDecoder:
    """Chunked decoding over a BeamDecoder's graph.

    Usage::

        ob = OnlineBeamDecoder(dec, chunk_frames=32)
        ob.reset()
        for scores_chunk in stream:       # (t, num_pdfs) pieces
            ob.advance(scores_chunk)
            words, cost = ob.partial()    # any time
        clat = ob.finalize()              # determinized CompactLattice
    """

    def __init__(self, dec: BeamDecoder, chunk_frames: int = 32,
                 max_frames: int = 2048):
        if not dec.L:
            raise KaldiError("OnlineBeamDecoder needs "
                             "lattice_arcs_per_frame on the BeamDecoder")
        self.dec = dec
        self.C = chunk_frames
        self.maxT = max_frames
        # donate the carried state: the chunk step then updates the
        # record/backpointer buffers in place instead of copying
        # hundreds of MB per step at the jit boundary
        self._chunk_jit = jax.jit(self._chunk_fn,
                                  donate_argnums=(1, 2, 3, 4, 5))
        self._partial_jit = jax.jit(self._partial_fn)
        self.reset()

    # -- device functions ---------------------------------------------------

    def _chunk_fn(self, g, tok, chunks, alphas, bpp, bpa, deficit,
                  frames_done, chunk_ll, n_valid):
        """Advance over one padded chunk.  Records are stored in the
        offline β-prune layout — per-frame (L, recw+1) chunk rows
        (with the device-only cost column) plus per-frame source-token
        costs — so finalize() can run the device β pass and fetch only
        records the final lattice keeps (otherwise the finalize tail
        is the record fetch)."""
        dec = self.dec
        dec.g = g
        active = jnp.arange(self.C) < n_valid
        (tok,), scanned = jax.lax.scan(
            dec._frame_step_beta, (tok,), (chunk_ll, active))
        prev, aidxs = scanned[0], scanned[1]
        eff_beam = scanned[5]
        chunk_y, alpha_y = scanned[6], scanned[7]
        # accumulated beam deficit (inactive frames report eff_beam =
        # beam, contributing 0) — the escalation trigger, fetched only
        # at finalize
        deficit = deficit + jnp.sum(jnp.maximum(
            jnp.float32(dec.config.lattice_beam) - eff_beam, 0.0))
        # chunk rows land at the filled prefix; a partial final chunk's
        # inactive rows are overwritten by the next chunk
        bpp = jax.lax.dynamic_update_slice(bpp, prev, (frames_done, 0))
        bpa = jax.lax.dynamic_update_slice(bpa, aidxs, (frames_done, 0))
        chunks = jax.lax.dynamic_update_slice(
            chunks, chunk_y, (frames_done, jnp.int32(0), jnp.int32(0)))
        alphas = jax.lax.dynamic_update_slice(
            alphas, alpha_y, (frames_done, jnp.int32(0)))
        return (tok, chunks, alphas, bpp, bpa, deficit,
                frames_done + n_valid)

    def _partial_fn(self, g, tok, bpp, bpa, frames_done):
        """Best token now (+final cost if any state is final), device
        traceback over the filled prefix → (arc-index path, cost,
        per-token final costs)."""
        fs, fc = tok[0], tok[1]
        okf = fs >= 0
        fin = g["final"][jnp.where(okf, fs, 0)]
        total = jnp.where(okf, fc + fin, INF)
        any_final = jnp.isfinite(total).any()
        use = jnp.where(any_final, total, jnp.where(okf, fc, INF))
        best = jnp.argmin(use).astype(jnp.int32)
        out = jnp.full((self.maxT,), -1, jnp.int32)

        def cond(c):
            return (c[0] > 0) & (c[1] >= 0)

        def body(c):
            t, idx, out = c
            t = t - 1
            out = jax.lax.dynamic_update_slice(out, bpa[t, idx][None],
                                               (t,))
            return (t, bpp[t, idx], out)

        _, end_slot, out = jax.lax.while_loop(
            cond, body, (frames_done, best, out))
        # end_slot = the winning path's slot at frame 0 (an initial
        # token) — maps to a start-closure olabel on the host
        return out, use[best], jnp.where(okf, fin, INF), end_slot

    # -- host API -------------------------------------------------------

    def reset(self) -> None:
        dec = self.dec
        g = dec._graph_arrays()
        K = dec.K
        # copies, not references: the chunk step DONATES its token
        # carry, and the graph's init arrays must survive resets
        self._tok = tuple(jnp.array(g[k]) for k in
                          ("init_state", "init_cost", "init_off",
                           "init_cnt"))
        # full-stream per-frame record chunks (+ device-only cost
        # column) and source-token costs, HBM-resident — finalize
        # β-prunes on device and ships only surviving records
        self._chunks = jnp.zeros((self.maxT, dec.L, dec._recw + 1),
                                 jnp.int32)
        self._alphas = jnp.full((self.maxT, K), jnp.inf, jnp.float32)
        self._bpp = jnp.zeros((self.maxT, K), jnp.int32)
        self._bpa = jnp.full((self.maxT, K), -1, jnp.int32)
        self._deficit = jnp.float32(0.0)
        self._frames = 0
        self._ll_parts: List[np.ndarray] = []
        self._pending: Optional[np.ndarray] = None

    def _run_chunk(self, chunk: np.ndarray, n_valid: int) -> None:
        g = self.dec._graph_arrays()
        (self._tok, self._chunks, self._alphas, self._bpp, self._bpa,
         self._deficit, _fd) = self._chunk_jit(
            g, self._tok, self._chunks, self._alphas, self._bpp,
            self._bpa, self._deficit,
            jnp.int32(self._frames),
            jnp.asarray(chunk, jnp.float32), jnp.int32(n_valid))
        self._frames += n_valid
        if self._frames + self.C > self.maxT:
            raise KaldiError("OnlineBeamDecoder: max_frames exceeded")
        # background-compile the finalize β program for the bucket the
        # stream is in AND the next one (a compile takes longer than a
        # few chunks — starting a bucket early means finalize never
        # joins an in-flight compile)
        Tb = min(-(-max(self._frames, 1) // 256) * 256, self.maxT)
        self.dec.prewarm_finalize_beta(Tb)
        self.dec.prewarm_finalize_beta(min(Tb + 256, self.maxT))

    def advance(self, loglikes: np.ndarray) -> None:
        """Consume a (t, num_pdfs) score chunk (any t ≥ 0)."""
        ll = np.asarray(loglikes, np.float32)
        self._ll_parts.append(ll)
        buf = (ll if self._pending is None
               else np.concatenate([self._pending, ll]))
        while buf.shape[0] >= self.C:
            self._run_chunk(buf[:self.C], self.C)
            buf = buf[self.C:]
        self._pending = buf

    def _flush(self) -> None:
        if self._pending is not None and self._pending.shape[0]:
            n = self._pending.shape[0]
            pad = np.zeros((self.C - n, self._pending.shape[1]),
                           np.float32)
            self._run_chunk(np.concatenate([self._pending, pad]), n)
            self._pending = np.zeros((0, self._pending.shape[1]),
                                     np.float32)

    @property
    def num_frames_decoded(self) -> int:
        return self._frames + (0 if self._pending is None
                               else self._pending.shape[0])

    def partial(self) -> Tuple[List[int], float]:
        """(olabel sequence so far, best cost) — BestPathEnd +
        TraceBackBestPath at the current frame."""
        self._flush()
        if self._frames == 0:
            return [], 0.0
        path, cost, _fin, slot0 = self._partial_jit(
            self.dec._graph_arrays(), self._tok, self._bpp, self._bpa,
            jnp.int32(self._frames))
        return self._path_olabels(path, slot0), float(cost)

    def partial_tids(self) -> List[int]:
        """tid alignment of the current best path (silence-weighting /
        endpointing input)."""
        self._flush()
        if self._frames == 0:
            return []
        path, _cost, _fin, _s0 = self._partial_jit(
            self.dec._graph_arrays(), self._tok, self._bpp, self._bpa,
            jnp.int32(self._frames))
        aidx = np.asarray(path)[:self._frames]
        aidx = aidx[aidx >= 0]
        return [int(t) for t in self.dec._flat[aidx, 2] if t]

    def _path_olabels(self, path, slot0) -> List[int]:
        """Expand the winning arc-index path into plain word olabels
        (sequence-encoded arcs + the initial token's start-closure
        olabel)."""
        aidx = np.asarray(path)[:self._frames]
        aidx = aidx[aidx >= 0]
        dec = self.dec
        ols = list(dec._expand_ol(int(dec._init_ols[int(slot0)])))
        for o in dec._flat[aidx, 4]:
            if o:
                ols.extend(dec._expand_ol(int(o)))
        return ols

    def finalize(self, max_states: int = 200000):
        """Determinized CompactLattice over everything consumed (the
        GetLattice(final=true) contract).  When the BeamDecoder's
        escalation policy is enabled and the stream's accumulated beam
        deficit fired the trigger, the WHOLE utterance is re-decoded
        offline at the escalated budget from the retained loglikes —
        streaming semantics for partials, offline quality for the
        final lattice (online2's GetLattice(final=true) is likewise
        allowed to be more expensive than AdvanceDecoding)."""
        import time as _time
        self._flush()
        if self._frames == 0:
            raise KaldiError("OnlineBeamDecoder: no frames decoded")
        dec = self.dec
        bd = self.last_finalize_breakdown = {}
        if dec.deficit_fires(self._deficit):
            t0 = _time.perf_counter()
            ll = np.concatenate(self._ll_parts)[:self._frames]
            out = dec._escalator().decode_compact(
                ll, bucket=self.C, max_states=max_states)
            bd["escalated_redecode_ms"] = \
                (_time.perf_counter() - t0) * 1e3
            return out
        t0 = _time.perf_counter()
        _path, _cost, fin, _s0 = self._partial_jit(
            dec._graph_arrays(), self._tok, self._bpp, self._bpa,
            jnp.int32(self._frames))
        # device β pass over the stored chunks: fetch only records on
        # paths within lattice_beam of the best (Tb-bucketed so a
        # stream of lengths reuses a handful of compiled programs)
        Tb = min(-(-max(self._frames, 1) // 256) * 256, self.maxT)
        fb = dec._get_finalize_beta(Tb)
        buf, cnts, cursor = fb(dec._graph_arrays(),
                               self._chunks[:Tb], self._alphas[:Tb],
                               jnp.int32(self._frames), self._tok)
        fin_np = np.asarray(fin)
        ncur = int(cursor)
        t1 = _time.perf_counter()
        bd["device_ms"] = (t1 - t0) * 1e3
        nb = min(-(-max(ncur, 1) // 4096) * 4096, buf.shape[0])
        host = {
            "rec_counts": np.asarray(cnts)[:self._frames],
            "rec_packed": np.asarray(buf[:nb])[:ncur],
            "tok_final": fin_np,
            "rec_reversed": 1,
        }
        t2 = _time.perf_counter()
        bd["record_fetch_ms"] = (t2 - t1) * 1e3
        bd["n_records"] = ncur
        ll = np.concatenate(self._ll_parts)
        out = dec.build_compact_lattice(host, self._frames, ll,
                                        max_states=max_states)
        bd["build_determinize_ms"] = (_time.perf_counter() - t2) * 1e3
        return out

    # -- SingleUtteranceNnet3Decoder-compatible surface -------------------

    def advance_decoding(self, loglikes: np.ndarray) -> None:
        self.advance(loglikes)

    def get_best_path(self, use_final_probs: bool = True
                      ) -> Tuple[List[int], List[int], float]:
        """(tids, olabels, cost) of the current best path."""
        self._flush()
        if self._frames == 0:
            raise KaldiError("OnlineBeamDecoder: no frames decoded")
        path, cost, _fin, slot0 = self._partial_jit(
            self.dec._graph_arrays(), self._tok, self._bpp, self._bpa,
            jnp.int32(self._frames))
        aidx = np.asarray(path)[:self._frames]
        aidx = aidx[aidx >= 0]
        tids = [int(t) for t in self.dec._flat[aidx, 2] if t]
        return tids, self._path_olabels(path, slot0), float(cost)

    def trailing_silence_frames(self, tm=None, silence_phones=()) -> int:
        tm = tm or getattr(self, "tm", None)
        silence_phones = set(silence_phones) or getattr(
            self, "silence_phones", set())
        if tm is None or not silence_phones:
            return 0
        n = 0
        for tid in reversed(self.partial_tids()):
            if tm.transition_id_to_phone(tid) in silence_phones:
                n += 1
            else:
                break
        return n

    def endpoint_detected(self, rules=None, frame_shift: float = 0.03,
                          tm=None, silence_phones=()) -> bool:
        """online-endpoint.h EndpointDetected over the current tokens
        (frame_shift defaults to the chain ×3-subsampled rate)."""
        from kaldi_tpu.decoder.online import default_endpoint_rules
        self._flush()
        if self._frames == 0:
            return False
        rules = rules or default_endpoint_rules()
        utt_len = self._frames * frame_shift
        trailing = self.trailing_silence_frames(tm, silence_phones) \
            * frame_shift
        contains_nonsil = trailing < utt_len
        fc = np.asarray(self._tok[1])
        fs = np.asarray(self._tok[0])
        fin = np.asarray(self.dec._g_host["final"])[np.maximum(fs, 0)]
        total = np.where(fs >= 0, fc + fin, np.inf)
        best_any = float(np.min(np.where(fs >= 0, fc, np.inf)))
        best_final = float(np.min(total))
        relative_cost = (best_final - best_any
                         if np.isfinite(best_final) else 1e10)
        for r in rules:
            if r.must_contain_nonsilence and not contains_nonsil:
                continue
            if trailing < r.min_trailing_silence:
                continue
            if relative_cost > r.max_relative_cost:
                continue
            if utt_len < r.min_utterance_length:
                continue
            return True
        return False


class MultiStreamBeamDecoder:
    """N concurrent streaming channels on one chip (the CudaDecoder
    multi-lane/multi-channel model: LaneCounters/ChannelCounters in
    cuda-decoder.h).  All channel state lives in HBM with a leading
    channel axis; one vmapped compiled chunk step advances every
    channel at once (idle channels ride along with n_valid = 0 —
    identity token steps).  Channels are independently reset and
    finalized, so utterances of different lengths stream through the
    same lanes back-to-back, as in the batched GPU pipeline."""

    def __init__(self, dec: BeamDecoder, n_channels: int = 8,
                 chunk_frames: int = 32, max_frames: int = 2048,
                 rec_rows: Optional[int] = None):
        if not dec.L:
            raise KaldiError("MultiStreamBeamDecoder needs "
                             "lattice_arcs_per_frame")
        del rec_rows      # kept for API compat; records live (T, L)
        self.dec = dec
        self.N = n_channels
        self.C = chunk_frames
        self.maxT = max_frames
        one = OnlineBeamDecoder.__new__(OnlineBeamDecoder)
        one.dec = dec
        one.C = chunk_frames
        one.maxT = max_frames
        self._single = one                       # for _chunk_fn reuse
        self._chunk_jit = jax.jit(
            jax.vmap(one._chunk_fn,
                     in_axes=(None, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
            donate_argnums=(1, 2, 3, 4, 5))
        self._partial_jit = jax.jit(jax.vmap(
            one._partial_fn, in_axes=(None, 0, 0, 0, 0)))
        self._reset_all()

    def _reset_all(self) -> None:
        dec = self.dec
        g = dec._graph_arrays()
        N, K = self.N, dec.K
        tile = lambda a: jnp.broadcast_to(a, (N,) + a.shape)
        self._tok = tuple(jnp.array(tile(g[k])) for k in
                          ("init_state", "init_cost", "init_off",
                           "init_cnt"))
        self._chunks = jnp.zeros(
            (N, self.maxT, dec.L, dec._recw + 1), jnp.int32)
        self._alphas = jnp.full((N, self.maxT, K), jnp.inf, jnp.float32)
        self._bpp = jnp.zeros((N, self.maxT, K), jnp.int32)
        self._bpa = jnp.full((N, self.maxT, K), -1, jnp.int32)
        self._deficit = jnp.zeros((N,), jnp.float32)
        self._frames = np.zeros(N, np.int64)
        self._ll: List[List[np.ndarray]] = [[] for _ in range(N)]

    def reset_channel(self, c: int) -> None:
        dec = self.dec
        g = dec._graph_arrays()
        names = ("init_state", "init_cost", "init_off", "init_cnt")
        self._tok = tuple(t.at[c].set(g[k])
                          for t, k in zip(self._tok, names))
        self._bpa = self._bpa.at[c].set(-1)
        self._deficit = self._deficit.at[c].set(0.0)
        self._frames[c] = 0
        self._ll[c] = []

    def advance(self, chunks: List[Optional[np.ndarray]]) -> None:
        """chunks[c] = (t ≤ chunk_frames, P) scores for channel c, or
        None for an idle channel.  One vmapped device step."""
        assert len(chunks) == self.N
        P = self.dec.num_pdfs
        X = np.zeros((self.N, self.C, P), np.float32)
        nv = np.zeros(self.N, np.int32)
        for c, ch in enumerate(chunks):
            if ch is None or len(ch) == 0:
                continue
            ch = np.asarray(ch, np.float32)
            if ch.shape[0] > self.C:
                raise KaldiError("advance: chunk longer than "
                                 "chunk_frames")
            X[c, :ch.shape[0]] = ch
            nv[c] = ch.shape[0]
            self._ll[c].append(ch)
        g = self.dec._graph_arrays()
        (self._tok, self._chunks, self._alphas, self._bpp, self._bpa,
         self._deficit, _fd) = self._chunk_jit(
            g, self._tok, self._chunks, self._alphas, self._bpp,
            self._bpa, self._deficit,
            jnp.asarray(self._frames, jnp.int32), jnp.asarray(X),
            jnp.asarray(nv))
        self._frames += nv
        if (self._frames.max() + self.C) > self.maxT:
            raise KaldiError("MultiStreamBeamDecoder: max_frames "
                             "exceeded")
        Tb = min(-(-max(int(self._frames.max()), 1) // 256) * 256,
                 self.maxT)
        self.dec.prewarm_finalize_beta(Tb)
        self.dec.prewarm_finalize_beta(min(Tb + 256, self.maxT))

    def finalize_channel(self, c: int, max_states: int = 200000):
        """Determinized CompactLattice for channel c (then
        reset_channel(c) to reuse the lane)."""
        dec = self.dec
        T = int(self._frames[c])
        if T == 0:
            raise KaldiError("finalize_channel: no frames decoded")
        if dec.deficit_fires(np.asarray(self._deficit)[c]):
            ll = np.concatenate(self._ll[c])[:T]
            return dec._escalator().decode_compact(
                ll, bucket=self.C, max_states=max_states)
        _path, _cost, fin, _s0 = self._partial_jit(
            dec._graph_arrays(), self._tok, self._bpp, self._bpa,
            jnp.asarray(self._frames, jnp.int32))
        Tb = min(-(-max(T, 1) // 256) * 256, self.maxT)
        fb = dec._get_finalize_beta(Tb)
        tok_c = tuple(t[c] for t in self._tok)
        buf, cnts, cursor = fb(dec._graph_arrays(),
                               self._chunks[c, :Tb],
                               self._alphas[c, :Tb],
                               jnp.int32(T), tok_c)
        ncur = int(cursor)
        nb = min(-(-max(ncur, 1) // 4096) * 4096, buf.shape[0])
        host = {
            "rec_counts": np.asarray(cnts)[:T],
            "rec_packed": np.asarray(buf[:nb])[:ncur],
            "tok_final": np.asarray(fin[c]),
            "rec_reversed": 1,
        }
        ll = np.concatenate(self._ll[c])
        return dec.build_compact_lattice(host, T, ll,
                                         max_states=max_states)
