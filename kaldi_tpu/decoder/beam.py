"""Vectorized token-passing Viterbi beam decoder with exact lattice
generation, for graphs too large to decode densely.

Parity target: src/decoder/lattice-faster-decoder.h
(LatticeFasterDecoderTpl::{ProcessEmitting, ProcessNonemitting,
GetRawLattice}, LatticeFasterDecoderConfig{beam, max_active,
lattice_beam}) and the fork's GPU decoder (arXiv:1804.03243 — parallel
arc expansion with load-balanced work queues, token recombination, and
exact lattice arc recording on device).

Design premise: row gathers and scatters cost per ROW (independent
of row width) and scale with batch, while sorts, scans and elementwise
passes are bandwidth-bound and amortize.  The frame step is therefore
built around exactly ONE M-row gather (the packed arc fetch) and NO
scatters at all; everything downstream rides sorts as payload operands
instead of being re-gathered.  The per-op costs behind each choice
below were taken on the accelerator this decoder was first written
for; none has been measured on the GPU yet (ROADMAP S3 / D2), so each
choice stands on its premise until a GPU trace decides it:

  * ε arcs are ELIMINATED before decoding (biglang.eps_precompose
    folds each emitting arc with the ε-closure of its destination, and
    ε-to-final paths into final costs) — one sweep per frame instead
    of 1 + ε-depth, and ProcessNonemitting disappears.  The start
    state's ε closure becomes the initial token set, computed on host.
  * the graph is ONE packed int32 BLOCK table: each state's out-arc
    range is padded to a multiple of arc_block, a row holding blk
    consecutive arcs [nextstate, weight(bits), tid, pdf, olabel]×blk
    (padding arcs carry +inf weight → beam-pruned for free).  A frame
    fetches M arcs with an (M/blk)-row gather — the per-row cost is
    width-independent, so blocks divide the dominant gather by ~blk.
    Destination arc ranges live in a per-state table recovered with a
    cheap K-row gather AFTER top-K (never carried through sorts).
  * load balancing (the CudaFst work-queue): out-block counts are
    prefix-summed and the owning token of each of the MB block slots
    is searchsorted(cumsum, slot, 'right'), computed as one
    compare-reduce over (MB, K) + two MB-row gathers (alternatives: a
    binary-search while-loop, or a seed scatter + associative-scan
    forward fill — the scatter is what the premise avoids).
  * recombination = lax.sort by (next_state, cost); the first
    candidate of each equal-state run survives (atomic-min → sort +
    segment-head test).  Every per-candidate field the rest of the
    step needs (source token, tid, olabel, cost bits) rides the sorts
    as extra operands — an extra sort operand is cheaper than a
    post-sort M-row gather.
  * max-active = histogram cutoff over segment-head costs (GetCutoff /
    the GPU decoder's histogram prune: an adaptive beam, not an exact
    top-K), then winner slots assigned in state order by ONE cumsum —
    the compaction sort's key is the slot itself, so no winner-position
    scatter and no cost-ranked permutation to invert.
  * acoustic costs: one-hot masked reduction against the frame's
    loglikes for small pdf sets, plain gather above.
  * lattice: every candidate within lattice_beam of its state's best
    whose destination survived, sorted by extra-cost, first L appended
    to a per-utterance device record buffer by dynamic_update_slice at
    a running cursor (GetRawLattice's ForwardLinks; extra-cost priority
    keeps every Viterbi arc, so the best path is always in the
    lattice).  The cursor append replaces an end-of-scan compaction
    scatter over B·T·L rows.
    A record's destination slot is the same cumsum the compaction key
    uses; segment survival + head cost ride one forward-filled s32.
  * a record is TWO s32 words: [prev-slot | dst-slot] packed, and the
    ARC INDEX.  ilabel/olabel/graph-weight/pdf are recovered on host
    from the (host-resident) packed arc table, and the acoustic cost
    is recomputed from the host loglikes — bit-identical f32 — so
    nothing else rides the sorts or crosses the wire.  With
    record_capacity set, the record output has a fixed shape and
    start_fetch() overlaps the D2H copy with the next batch's compute.

Host-side assembly converts the packed records into a pruned raw
Lattice with exact α/β lattice-beam pruning — numpy-vectorized per
frame level (C++ fast path in native/lattice_build.cpp), no per-arc
Python loops.

The graph rides as a jit ARGUMENT pytree (never a closure constant:
multi-megabyte embedded literals stall lowering and compile, and would
recompile per graph); decode executables are AOT-compiled per input
shape from abstract avals.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.fst.csr import CsrGraph
from kaldi_tpu.lattice.lattice import Lattice, LatticeArc

log = get_logger(__name__)

INF = jnp.float32(jnp.inf)


class StageTimers:
    """Thread-safe cumulative wall-clock per host-assembly stage
    (records decode / native raw-lattice build / determinize).  The
    quality harness (pipelines/hard.decode_eval) resets and reads
    these to attribute decode wall time — the CuDevice::PrintProfile
    role for the host side."""

    def __init__(self):
        import threading
        self._lock = threading.Lock()
        self.t: Dict[str, float] = {}

    def add(self, key: str, dt: float) -> None:
        with self._lock:
            self.t[key] = self.t.get(key, 0.0) + dt

    def reset(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self.t)
            self.t.clear()
        return out

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.t)


BUILD_TIMERS = StageTimers()


@dataclasses.dataclass
class BeamDecoderConfig:
    """Mirrors LatticeFasterDecoderConfig option names."""
    beam: float = 16.0
    max_active: int = 7000         # K: token capacity
    acoustic_scale: float = 0.1
    lattice_beam: float = 8.0      # extra-cost beam for lattice arcs
    # device-side budgets (0 = auto):
    arc_budget: int = 0            # M: arcs expanded per frame
    lattice_arcs_per_frame: int = 0   # L: records per frame;
    #                                   0 disables lattice generation
    onehot_pdf_limit: int = 128    # one-hot-reduction scoring up to
    #                                this P; above it the (M, P) mask
    #                                outgrows a plain row gather (the
    #                                crossover is unmeasured on the GPU)
    arc_block: int = 8             # arcs fetched per gather row: a
    #                                gather's cost is per ROW regardless
    #                                of width, so fetching blocks of
    #                                consecutive arcs (each state's
    #                                range is block-aligned in the
    #                                padded table) divides the dominant
    #                                gather cost by ~arc_block; the
    #                                padding's extra in-budget losses
    #                                are what escalation recovers (the
    #                                value is unmeasured on the GPU)
    token_capacity: int = 0        # K: token array size (0 = max_active).
    #                                max_active is enforced by histogram
    #                                cutoff, so capacity can be sized to
    #                                measured occupancy independently of
    #                                the max-active contract
    record_capacity: int = 0       # per-utterance cap on the device
    #                                record buffer (0 = the full
    #                                T_pad·L rows).  The host fetch
    #                                device-slices to the true record
    #                                count before copying; overflow
    #                                raises at fetch time (size it ~2×
    #                                measured record counts)
    escalate_budget: int = 0       # > arc_budget enables demand-triggered
    #                                escalation in the lattice-decode APIs
    #                                (the DecodeUtteranceLatticeFaster
    #                                retry-beam contract applied to the
    #                                arc budget): an utterance whose
    #                                budget-imposed effective beam put
    #                                lattice arcs at risk is RE-DECODED
    #                                at this budget.  0 disables.
    device_beta_prune: bool = True  # run a reverse (β) pass ON DEVICE
    #                                after the forward scan and fetch
    #                                only records on paths within
    #                                lattice_beam of the best — most
    #                                within-beam candidate records die
    #                                in the host α/β prune, so this
    #                                trades device compute for fetch
    #                                bytes.  The device keep test is a
    #                                small-margin SUPERSET of the
    #                                host's exact f64 prune, so
    #                                lattices are unchanged.  Disabled
    #                                automatically when the (T·L)
    #                                chunk buffer would not fit the
    #                                device memory budget.
    beta_prune_margin: float = 0.1  # f32-vs-f64 safety margin on the
    #                                device keep bound (superset
    #                                guarantee; ~20σ above accumulated
    #                                f32 rounding at T≈3000)
    escalate_deficit: float = 4.0  # escalation trigger: re-decode when
    #                                the utterance's accumulated beam
    #                                DEFICIT — Σ_t max(0, lattice_beam −
    #                                eff_beam_t), the integral of how far
    #                                the arc budget pushed the effective
    #                                beam inside the lattice margin —
    #                                exceeds this.  A single marginal
    #                                frame (the r3 trigger, which flagged
    #                                83% of a hard corpus for a 0.01
    #                                oracle-WER payoff) no longer fires;
    #                                sustained budget pressure does.
    #                                0 = any dip fires (max conservative).


# device-β-prune memory budget: the stacked (B, T, L) chunk and α
# buffers may take this share of the device's memory limit, leaving the
# rest to the graph tables, the scan state and the record buffers
BETA_MEMORY_FRACTION = 0.25
# budget for a device that reports no memory limit (the CPU backend)
BETA_FIXED_BUDGET = 6 << 30


def beta_memory_budget(device) -> Tuple[int, str]:
    """(bytes, source) the device β-prune's buffers may use on
    ``device``: BETA_MEMORY_FRACTION of its ``bytes_limit`` when it
    reports one, else BETA_FIXED_BUDGET."""
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if limit:
        return (int(limit * BETA_MEMORY_FRACTION),
                f"{BETA_MEMORY_FRACTION} of bytes_limit {limit}")
    return BETA_FIXED_BUDGET, "fixed (device reports no bytes_limit)"


def _background(fn, *args):
    """Start fn(*args) in a one-shot worker thread under the caller's
    default device (jax.default_device is thread-local, and an AOT
    compile targets the default device) → Future."""
    import concurrent.futures as cf
    dev = jax.config.jax_default_device

    def run():
        with jax.default_device(dev):
            return fn(*args)

    ex = cf.ThreadPoolExecutor(1)
    fut = ex.submit(run)
    ex.shutdown(wait=False)
    return fut


def _default_device():
    """The device uncommitted computations run on."""
    d = jax.config.jax_default_device
    if isinstance(d, str):
        return jax.devices(d)[0]
    return d if d is not None else jax.devices()[0]


def _forward_fill(vals: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """vals where mask, forward-filled along axis 0 (associative)."""

    def op(a, b):
        av, af = a
        bv, bf = b
        return jnp.where(bf, bv, av), af | bf

    filled, _ = jax.lax.associative_scan(op, (vals, mask))
    return filled


class BeamDecoder:
    """Compiled decoder bound to one graph (the packed arc table lives
    in HBM once; every decode reuses it — CudaFst residency)."""

    def __init__(self, graph: CsrGraph, tid_to_pdf: np.ndarray,
                 config: BeamDecoderConfig = None):
        if graph.num_eps_arcs:
            from kaldi_tpu.fst.biglang import eps_precompose
            graph = eps_precompose(graph)
        self.graph = graph
        self.config = config or BeamDecoderConfig()
        cap = self.config.token_capacity or self.config.max_active
        self.K = max(1, min(cap, graph.num_states))
        self.maxa = min(self.config.max_active, self.K)
        blk = max(1, self.config.arc_block)
        self.BLK = blk
        self.L = self.config.lattice_arcs_per_frame
        if self.L and self.L < self.K:
            raise KaldiError("lattice_arcs_per_frame must be >= max_active "
                             "(every Viterbi arc must fit)")
        self.num_pdfs = int(tid_to_pdf.max()) + 1

        # block-aligned packed arc table: each state's out-arc range is
        # padded to a multiple of BLK so one gathered row = BLK
        # consecutive arcs of one state run; padding arcs carry +inf
        # weight (beam-pruned for free).  arc fields:
        # [ns, w_bits, il, pdf, ol]; the destination's own block range
        # lives in a per-state table gathered K-row-cheap after top-K
        A = graph.num_emitting_arcs
        S = graph.num_states
        cnt = (graph.e_offsets[1:] - graph.e_offsets[:-1]).astype(np.int64)
        cnt_blk = -(-cnt // blk)
        blk_off = np.zeros(S + 1, np.int64)
        np.cumsum(cnt_blk, out=blk_off[1:])
        A_blk = int(blk_off[-1])
        # budget in BLOCK space, capped at A_blk: active tokens hold
        # distinct states, so per-frame block demand can never exceed
        # the table's total block count (no drops at the cap)
        M = self.config.arc_budget or max(4 * self.K, 8192)
        self._A_blk = A_blk
        self.MB = min(max(A_blk, 1), -(-M // blk))
        # the compaction slices take [:K] of M-length sort operands and
        # every active token (distinct state) needs >= 1 block to
        # expand at all, so the budget floor is one block per token
        self.MB = max(self.MB, -(-self.K // blk))
        self.M = self.MB * blk         # expanded arc rows (sort width)
        # record packing: (prev slot, dst slot) share one s32 when the
        # bit budget allows (see _pack_pd below)
        self._tok_bits = max(1, (self.K - 1).bit_length())
        flat = np.zeros((max(A_blk, 1) * blk, 5), np.int32)
        flat[:, 1] = np.float32(np.inf).view(np.int32)
        if A:
            src = np.repeat(np.arange(S), cnt)
            pos = (blk_off[src] * blk
                   + (np.arange(A) - graph.e_offsets[src])).astype(np.int64)
            flat[pos, 0] = graph.e_nextstate
            flat[pos, 1] = graph.e_weight.view(np.int32)
            flat[pos, 2] = graph.e_ilabel
            flat[pos, 3] = np.asarray(tid_to_pdf, np.int32)[graph.e_ilabel]
            flat[pos, 4] = graph.e_olabel
        tab = flat.reshape(max(A_blk, 1), blk * 5)
        state_blk = np.stack([blk_off[:S].astype(np.int32),
                              cnt_blk.astype(np.int32)], axis=1)
        # host copy of the flat arc table: lattice records carry only
        # the arc INDEX; il/ol/gw/pdf are recovered here at build time
        self._flat = flat
        # record layout: [prev|dst] share one s32 when K's bit budget
        # allows (always, for realistic max-active), else 3 words
        self._pack_pd = 2 * max(1, (self.K - 1).bit_length()) <= 31
        self._recw = 2 if self._pack_pd else 3
        if self.config.record_capacity and self.L \
                and self.config.record_capacity < self.L:
            raise KaldiError("record_capacity must be >= "
                             "lattice_arcs_per_frame")

        init_states, init_costs = graph.initial_tokens()
        K = self.K
        ts = np.full(K, -1, np.int32)
        tc = np.full(K, np.float32(np.inf), np.float32)
        to = np.zeros(K, np.int32)
        tn = np.zeros(K, np.int32)
        n0 = min(len(init_states), K)
        ts[:n0] = init_states[:n0]
        tc[:n0] = init_costs[:n0]
        to[:n0] = blk_off[init_states[:n0]].astype(np.int32)
        tn[:n0] = cnt_blk[init_states[:n0]].astype(np.int32)
        # host-only: olabel-sequence table (arcs carrying several word
        # olabels after ε elimination) + per-initial-slot olabels (a
        # word on the start ε-closure path); expanded at backtrace /
        # lattice-build time — the device never interprets olabels
        self._ol_seqs = list(graph.olabel_seqs or [])
        io = np.zeros(K, np.int64)
        if graph.init_olabels is not None:
            io[:n0] = np.asarray(graph.init_olabels[:n0], np.int64)
        self._init_ols = io

        self._g_host = {
            "arc_tab": tab,
            "state_blk": state_blk,
            "final": np.asarray(graph.final_costs, np.float32),
            "init_state": ts, "init_cost": tc,
            "init_off": to, "init_cnt": tn,
        }
        self.g = None
        self._g_dev = None
        self._compiled = {}
        self._esc = None

    # config fields that do NOT affect the packed graph tables or the
    # token-array capacity K, so a decoder variant can share them
    _SHARED_SAFE = ("beam", "max_active", "acoustic_scale",
                    "lattice_beam", "arc_budget",
                    "lattice_arcs_per_frame", "record_capacity",
                    "escalate_budget", "escalate_deficit",
                    "device_beta_prune", "beta_prune_margin")

    def with_overrides(self, **overrides) -> "BeamDecoder":
        """A sibling decoder sharing this one's packed graph (host AND
        device copies) but with different budget/beam knobs — the
        retry-with-wider-beam contract (gmm-align-compiled's
        --retry-beam; DecodeUtteranceLatticeFaster's warn-and-go-on
        becomes re-decode-wider here).  Only knobs that leave the
        packed arc table and K untouched may change; each variant has
        its own compiled-executable cache.  acoustic_scale may NOT
        change when lattices are built (host acoustic-cost recovery
        reads self.config)."""
        import copy
        bad = set(overrides) - set(self._SHARED_SAFE)
        if bad:
            raise KaldiError(f"with_overrides: {sorted(bad)} change the "
                             "graph packing; construct a new BeamDecoder")
        clone = copy.copy(self)
        clone.config = dataclasses.replace(self.config, **overrides)
        clone.maxa = min(clone.config.max_active, clone.K)
        M = clone.config.arc_budget or max(4 * clone.K, 8192)
        clone.MB = min(max(self._A_blk, 1), -(-M // clone.BLK))
        # same budget floor as __init__: compaction slices take [:K]
        # of M-length operands, so M >= K always
        clone.MB = max(clone.MB, -(-clone.K // clone.BLK))
        clone.M = clone.MB * clone.BLK
        clone.L = clone.config.lattice_arcs_per_frame
        if clone.L and clone.L < clone.K:
            raise KaldiError("lattice_arcs_per_frame must be >= "
                             "max_active (every Viterbi arc must fit)")
        if clone.config.record_capacity and clone.L \
                and clone.config.record_capacity < clone.L:
            raise KaldiError("record_capacity must be >= "
                             "lattice_arcs_per_frame")
        clone._compiled = {}
        # share the device-resident graph if already uploaded; later
        # uploads are per-instance (harmless, just not deduplicated)
        clone._g_dev = self._g_dev
        clone._esc = None            # never inherit an escalator sibling
        return clone

    # ------------------------------------------------------------------
    # compilation plumbing
    # ------------------------------------------------------------------

    def _graph_arrays(self):
        if self._g_dev is None:
            self._g_dev = jax.device_put(self._g_host)
        return self._g_dev

    def _use_beta(self, shape) -> bool:
        """β-prune on device for this decode shape?  Needs lattices
        on, the config switch, and the (B, T, L) chunk buffers to fit
        the device memory budget (beta_memory_budget)."""
        if not (self.L and self.config.device_beta_prune):
            return False
        B = shape[0] if len(shape) == 3 else 1
        T_pad = shape[-2]
        bytes_needed = B * T_pad * 4 * (
            self.L * (2 * self._recw + 1) + self.K)
        budget, source = beta_memory_budget(_default_device())
        log.info("BeamDecoder: device β-prune needs %d bytes for %s; "
                 "budget %d bytes (%s)", bytes_needed, shape, budget,
                 source)
        return bytes_needed <= budget

    def _get_compiled(self, shape):
        """AOT-compile for a (B?, T_pad, P) shape from abstract avals,
        so one executable serves every batch of that shape."""
        if shape in self._compiled:
            return self._compiled[shape]
        sds = jax.ShapeDtypeStruct
        g_abs = {k: sds(v.shape, v.dtype) for k, v in self._g_host.items()}
        scan = partial(self._decode_scan, use_beta=self._use_beta(shape))
        if len(shape) == 2:
            fn = jax.jit(scan)
            args = (g_abs, sds(shape, jnp.float32), sds((), jnp.int32))
        else:
            fn = jax.jit(jax.vmap(scan, in_axes=(None, 0, 0)))
            args = (g_abs, sds(shape, jnp.float32),
                    sds((shape[0],), jnp.int32))
        compiled = fn.lower(*args).compile()
        self._compiled[shape] = compiled
        return compiled

    def _decode_jit(self, g, loglikes, num_frames):
        return self._get_compiled(tuple(loglikes.shape))(
            g, loglikes, num_frames)

    _decode_batch_jit = _decode_jit

    # ------------------------------------------------------------------
    # device-side pieces
    # ------------------------------------------------------------------

    def _acoustic(self, pdf: jnp.ndarray, loglike: jnp.ndarray
                  ) -> jnp.ndarray:
        """−scale · loglike[pdf]: one-hot masked reduction for small
        pdf sets (batch-amortized), row gather above (the (M, P) mask
        outgrows the gather)."""
        if self.num_pdfs <= self.config.onehot_pdf_limit:
            oh = pdf[:, None] == jnp.arange(self.num_pdfs,
                                            dtype=jnp.int32)[None, :]
            ll = jnp.sum(jnp.where(oh, loglike[None, :], 0.0), axis=1)
        else:
            ll = loglike[pdf]
        return -self.config.acoustic_scale * ll

    def _sweep(self, tok, loglike, with_cost=False):
        """One frame: load-balance → expand → recombine → top-K.

        tok = (state, cost, off, cnt) each (K,).  Returns (new_tok,
        vit (prev, tid, ol), record chunk (L, 6) | None, dropped).

        Exactly one M-row gather (the arc fetch), no scatters; every
        other per-candidate value rides the three sorts as a payload
        operand."""
        g = self.g
        K = self.K
        M = self.M
        MB = self.MB
        blk = self.BLK
        L = self.L
        S = self.graph.num_states
        tok_state, tok_cost, tok_off, tok_cnt = tok

        # 0. adaptive arc-budget beam (the GetCutoff role for the arc
        #    budget): when the frame's total block demand exceeds MB,
        #    prune WHOLE TOKENS by cost — a histogram over token costs
        #    weighted by each token's block count picks the tightest
        #    cost cutoff whose cumulative demand fits — so the budget
        #    falls on the best tokens instead of arbitrary slot order.
        #    (Residual overflow inside the cutoff bin is still clipped
        #    by in_range below, bounded by one bin's worth.)
        demand = jnp.sum(tok_cnt)
        NBA = 64
        tmin = jnp.min(jnp.where(jnp.isfinite(tok_cost), tok_cost,
                                 jnp.float32(jnp.inf)))
        tb = jnp.clip(((tok_cost - tmin)
                       * (NBA / self.config.beam)).astype(jnp.int32),
                      0, NBA - 1)
        tb = jnp.where(jnp.isfinite(tok_cost), tb, NBA - 1)
        blk_hist = jnp.sum(
            jnp.where(tb[:, None] == jnp.arange(NBA, dtype=jnp.int32),
                      tok_cnt[:, None], 0), axis=0)
        cut_a = jnp.maximum(
            jnp.sum((jnp.cumsum(blk_hist) <= MB).astype(jnp.int32)) - 1, 0)
        tok_cnt = jnp.where((demand <= MB) | (tb <= cut_a), tok_cnt, 0)
        # effective token-cost beam the budget imposed this frame: below
        # lattice_beam means lattice arcs inside the lattice-beam margin
        # were dropped (the oracle-WER loss mechanism) — surfaced
        # per utterance as min_eff_beam for escalation policies
        eff_beam = jnp.where(
            demand <= MB, jnp.float32(self.config.beam),
            (cut_a.astype(jnp.float32) + 1.0)
            * (self.config.beam / NBA))

        # 1. load-balanced BLOCK distribution (tok_off/tok_cnt are in
        #    block units).  cum is monotone, so the owning token of
        #    block slot j is searchsorted(cum, j, 'right') — computed
        #    as one compare-reduce over (MB, K) plus two MB-row
        #    gathers from K-sized token tables, in place of a
        #    seed-scatter + forward-fill pair.
        cum = jnp.cumsum(tok_cnt)
        j = jnp.arange(MB, dtype=jnp.int32)
        starts = jnp.concatenate([jnp.zeros(1, cum.dtype), cum[:-1]])
        cost_sane = jnp.where(jnp.isfinite(tok_cost), tok_cost,
                              jnp.float32(1e30))
        # the count is a (MB, K) 0/1 matrix times ones — a matmul
        # (f32 accumulation is exact up to 2^24 ≫ K) in place of an
        # s32 compare-reduce of the same matrix
        cmp = (cum[None, :] <= j[:, None]).astype(jnp.bfloat16)
        cnt_le = jax.lax.dot_general(
            cmp, jnp.ones((K,), jnp.bfloat16), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        tok_of = jnp.minimum(cnt_le.astype(jnp.int32), K - 1)
        # one (K, 2)-row table gather for both per-token fields (two
        # separate 1-wide gathers each re-fuse a copy of the
        # compare-reduce above — 2x its cost)
        tk = jnp.stack([tok_off - starts.astype(jnp.int32),
                        jax.lax.bitcast_convert_type(cost_sane,
                                                     jnp.int32)], -1)
        rows2 = tk[tok_of]
        delta_f = rows2[:, 0]
        cost_f = jax.lax.bitcast_convert_type(rows2[:, 1], jnp.float32)
        in_range = j < cum[K - 1]
        # cost-cutoff-pruned blocks + residual in-bin overflow
        dropped = ((demand - cum[K - 1])
                   + jnp.maximum(cum[K - 1] - MB, 0)) * blk

        # 2. expand: ONE MB-row gather of (blk·5)-wide block rows —
        #    ~blk× cheaper than an M-row gather of single arcs
        bidx = jnp.clip(j + delta_f, 0, self.g["arc_tab"].shape[0] - 1)
        rows = g["arc_tab"][bidx].reshape(MB, blk, 5).reshape(M, 5)
        # flat arc index: the one payload that rides every sort (all
        # other arc fields are recovered from it by K-row gathers on
        # device or from the host table at lattice-build time)
        aidx = (bidx[:, None] * blk
                + jnp.arange(blk, dtype=jnp.int32)[None, :]).reshape(M)
        lane = lambda x: jnp.broadcast_to(x[:, None], (MB, blk)).reshape(M)
        tok_of = lane(tok_of)
        cost_f = lane(cost_f)
        c_state = rows[:, 0]
        gw = jax.lax.bitcast_convert_type(rows[:, 1], jnp.float32)
        ac = self._acoustic(rows[:, 3], loglike)
        c_cost = jnp.where(lane(in_range), cost_f + gw + ac, INF)

        # 3. beam prune + sort-based recombination (payloads ride)
        best = jnp.min(c_cost)
        fin = c_cost <= best + self.config.beam
        c_cost = jnp.where(fin, c_cost, INF)
        sort_state = jnp.where(fin, c_state, S)
        ops1 = (sort_state, c_cost, tok_of, aidx)
        s1 = jax.lax.sort(ops1, num_keys=2)
        st_s, cost_s, prev_s, aidx_s = s1
        first = jnp.concatenate([jnp.ones(1, bool), st_s[1:] != st_s[:-1]])
        head = first & (st_s < S)
        n_heads = jnp.sum(head.astype(jnp.int32))
        self._diag = (demand * blk, n_heads, eff_beam)

        # 4. max-active via histogram cutoff (GetCutoff / the GPU
        #    decoder's histogram prune: an adaptive beam, not an exact
        #    top-K), then slot assignment in state order by ONE cumsum.
        #    Surviving slots are 0..n-1 in sorted-position order, so
        #    the compaction sort key is the slot itself — no winner
        #    scatter, no cost-ranked permutation to invert.
        NB = 64
        maxa = self.maxa
        hb = jnp.clip(((cost_s - best) * (NB / self.config.beam))
                      .astype(jnp.int32), 0, NB - 1)
        hist = jnp.sum(
            jnp.where(head[:, None]
                      & (hb[:, None] == jnp.arange(NB, dtype=jnp.int32)),
                      1, 0), axis=0)
        cut_bin = jnp.maximum(
            jnp.sum((jnp.cumsum(hist) <= maxa).astype(jnp.int32)) - 1, 0)
        keep_head = head & ((n_heads <= maxa) | (hb <= cut_bin))
        slot = jnp.cumsum(keep_head.astype(jnp.int32)) - 1
        valid = keep_head & (slot < maxa)
        key2 = jnp.where(valid, slot, M)
        ops2 = (key2, st_s, cost_s, prev_s, aidx_s)
        s2 = jax.lax.sort(ops2, num_keys=1)
        slot2, st2, cost2, prev2, aidx2 = s2
        ok = slot2[:K] < M
        new_state = jnp.where(ok, st2[:K], -1)
        new_cost = jnp.where(ok, cost2[:K], INF)
        # destination block ranges: one K-row gather from the per-state
        # table (K-row gathers are ~us; only M-row gathers hurt)
        sb = g["state_blk"][jnp.maximum(new_state, 0)]
        new_off = jnp.where(ok, sb[:, 0], 0)
        new_cnt = jnp.where(ok, sb[:, 1], 0)
        # Viterbi backpointers carry (prev slot, arc index) only; the
        # backtrace emits the (T,) winning arc-index path and the HOST
        # maps tid/olabel from its arc-table copy — no K-row arc-field
        # gather in the sweep (a (K, blk·5) gather cost ~1.5–5 ms/step)
        vit = (jnp.where(ok, prev2[:K], -1),
               jnp.where(ok, aidx2[:K], -1))
        new_tok = (new_state, new_cost, new_off, new_cnt)

        if not L:
            return new_tok, vit, None, dropped

        # 5. lattice records: each candidate needs its segment head's
        #    cost and slot.  The slot is the keep_head cumsum (valid
        #    whenever the segment survived); survival + head cost ride
        #    ONE forward-filled s32 (cost bits, +inf bits marking cut
        #    segments) — no scatter, no second fill array
        seg_seed = jnp.where(valid, cost_s, INF)
        segcost_b = _forward_fill(
            jax.lax.bitcast_convert_type(seg_seed, jnp.int32), head)
        seg_cost = jax.lax.bitcast_convert_type(segcost_b, jnp.float32)
        extra = cost_s - seg_cost
        dst_slot = jnp.clip(slot, 0, K - 1)
        keep = (jnp.isfinite(cost_s) & jnp.isfinite(seg_cost)
                & (extra <= self.config.lattice_beam))
        key3 = jnp.where(keep, extra, INF)

        def fit(x, fill):
            if x.shape[0] >= L:
                return x[:L]
            return jnp.concatenate(
                [x, jnp.full((L - x.shape[0],), fill, x.dtype)])

        # with_cost (the device β-prune path): the record's forward
        # path cost α(prev)+w rides the sort as one more operand and
        # becomes a DEVICE-ONLY chunk column — the β pass needs it,
        # it never crosses the link
        cb = jax.lax.bitcast_convert_type(cost_s, jnp.int32)
        if self._pack_pd:
            # record = ([prev|dst] s32, arc index s32): 2 sort payload
            # operands and 8 B/record across the wire
            pd = jnp.where(keep,
                           (prev_s << self._tok_bits) | dst_slot, -1)
            if with_cost:
                key3s, rpd, raidx, rcb = jax.lax.sort(
                    (key3, pd, aidx_s, cb), num_keys=1)
            else:
                key3s, rpd, raidx = jax.lax.sort((key3, pd, aidx_s),
                                                 num_keys=1)
            rvalid = jnp.isfinite(fit(key3s, jnp.inf))
            cols = [jnp.where(rvalid, fit(rpd, -1), -1),
                    jnp.where(rvalid, fit(raidx, 0), 0)]
        else:
            if with_cost:
                key3s, rprev, rd, raidx, rcb = jax.lax.sort(
                    (key3, prev_s, dst_slot, aidx_s, cb), num_keys=1)
            else:
                key3s, rprev, rd, raidx = jax.lax.sort(
                    (key3, prev_s, dst_slot, aidx_s), num_keys=1)
            rvalid = jnp.isfinite(fit(key3s, jnp.inf))
            cols = [jnp.where(rvalid, fit(rprev, 0), -1),
                    jnp.where(rvalid, fit(rd, -1), 0),
                    jnp.where(rvalid, fit(raidx, 0), 0)]
        if with_cost:
            inf_b = jax.lax.bitcast_convert_type(INF, jnp.int32)
            cols.append(jnp.where(rvalid, fit(rcb, inf_b), inf_b))
        chunk = jnp.stack(cols, axis=-1)
        return new_tok, vit, chunk, dropped

    def _frame_step(self, carry, xs):
        loglike, active = xs
        K = self.K
        tok, buf, cursor = carry
        new_tok, vit, chunk, dropped = self._sweep(tok, loglike)
        # identity step for padded frames (active is a prefix, so a
        # padded frame's garbage chunk write beyond the final cursor
        # is never read by the host)
        new_tok = tuple(jnp.where(active, n, c)
                        for n, c in zip(new_tok, tok))
        idn = jnp.arange(K, dtype=jnp.int32)
        vit = (jnp.where(active, vit[0], idn),
               jnp.where(active, vit[1], -1))
        arcs_demand, n_heads, eff_beam = self._diag
        out = vit + (jnp.where(active, dropped, 0),
                     jnp.where(active, arcs_demand, 0),
                     jnp.where(active, n_heads, 0),
                     jnp.where(active, eff_beam,
                               jnp.float32(self.config.beam)))
        if chunk is not None:
            cnt = jnp.where(
                active, jnp.sum((chunk[:, 0] >= 0).astype(jnp.int32)), 0)
            # contiguous append at the running cursor: a handful of
            # block DMAs instead of a B·T·L-row compaction scatter
            buf = jax.lax.dynamic_update_slice(
                buf, chunk, (cursor, jnp.int32(0)))
            cursor = cursor + cnt
            out = out + (cnt,)
        return (new_tok, buf, cursor), out

    def _frame_step_beta(self, carry, xs):
        """Forward step for the device-β-prune path: per-frame record
        chunks (with the cost column) and source-token costs come out
        as stacked scan OUTPUTS instead of a cursor-append — the β
        pass consumes them frame-segmented."""
        loglike, active = xs
        K = self.K
        (tok,) = carry
        new_tok, vit, chunk, dropped = self._sweep(tok, loglike,
                                                   with_cost=True)
        alpha_t = tok[1]                 # source-token costs at t
        new_tok = tuple(jnp.where(active, n, c)
                        for n, c in zip(new_tok, tok))
        idn = jnp.arange(K, dtype=jnp.int32)
        vit = (jnp.where(active, vit[0], idn),
               jnp.where(active, vit[1], -1))
        arcs_demand, n_heads, eff_beam = self._diag
        # inactive frames emit an all-invalid chunk so the β pass
        # keeps nothing from them
        chunk = jnp.where(active, chunk,
                          chunk.at[:, 0].set(-1))
        out = vit + (jnp.where(active, dropped, 0),
                     jnp.where(active, arcs_demand, 0),
                     jnp.where(active, n_heads, 0),
                     jnp.where(active, eff_beam,
                               jnp.float32(self.config.beam)),
                     chunk, alpha_t)
        return (new_tok,), out

    def _beta_step(self, bound, carry, xs):
        """One reverse (β) frame: keep records on complete paths
        within `bound`, pack them to a prefix (original order), append
        at the running cursor; propagate β to the earlier frame.
        β[t][prev] = min over prev's kept candidates of (w + β[t+1]
        [dst]) = min(fc + β[dst]) − α[t][prev]."""
        K = self.K
        beta, buf, cursor = carry
        chunk, alpha_t, active = xs
        C = chunk.shape[1]
        pd0 = chunk[:, 0]
        valid = pd0 >= 0
        if self._pack_pd:
            prev = jnp.clip(pd0 >> self._tok_bits, 0, K - 1)
            dst = jnp.clip(pd0 & ((1 << self._tok_bits) - 1), 0, K - 1)
        else:
            prev = jnp.clip(pd0, 0, K - 1)
            dst = jnp.clip(chunk[:, 1], 0, K - 1)
        fc = jax.lax.bitcast_convert_type(chunk[:, C - 1], jnp.float32)
        v = jnp.where(valid, fc + beta[dst], INF)
        keep = valid & (v <= bound) & active
        # pack kept rows first, original (extra-cost) order preserved
        L = chunk.shape[0]
        order = jnp.where(keep, 0, L) + jnp.arange(L, dtype=jnp.int32)
        ops = (order,) + tuple(chunk[:, i] for i in range(self._recw))
        s = jax.lax.sort(ops, num_keys=1)
        rows = jnp.stack(
            [jnp.where(s[0] < L, s[1 + i], -1 if i == 0 else 0)
             for i in range(self._recw)], axis=-1)
        cnt = jnp.sum(keep.astype(jnp.int32))
        buf = jax.lax.dynamic_update_slice(buf, rows,
                                           (cursor, jnp.int32(0)))
        cursor = cursor + cnt
        # β for the earlier frame (over ALL valid candidates, not just
        # kept — the β recursion itself is exact, the bound only
        # filters what crosses the link).  Dense (K,) construction is
        # SORT-based, like every other dense array in this decoder
        # (the scatter-free premise; an .at[prev].min formulation is
        # the alternative a GPU trace may prefer): append one +inf
        # filler per slot so every prev is present, sort by (prev, v)
        # — each run's head is its min — then sort heads by prev; the
        # first K rows ARE dense β in slot order.
        kidx = jnp.arange(K, dtype=jnp.int32)
        prev_all = jnp.concatenate([prev, kidx])
        v_all = jnp.concatenate([v, jnp.full((K,), INF)])
        p_s, v_s = jax.lax.sort((prev_all, v_all), num_keys=2)
        headp = jnp.concatenate(
            [jnp.ones((1,), bool), p_s[1:] != p_s[:-1]])
        key2 = jnp.where(headp, p_s, jnp.int32(K))
        bsum = jax.lax.sort((key2, v_s), num_keys=1)[1][:K]
        nb = jnp.where(jnp.isfinite(bsum) & jnp.isfinite(alpha_t),
                       bsum - alpha_t, INF)
        beta = jnp.where(active, nb, beta)
        return (beta, buf, cursor), cnt

    def _decode_scan(self, g, loglikes, num_frames, use_beta=False):
        """g: graph pytree; loglikes: (T_pad, P); num_frames: int."""
        self.g = g
        K = self.K
        # runtime-tied init (prevents XLA constant-folding into the
        # slow literal interpreter)
        rt_zero = jnp.minimum(num_frames, 0)
        tok = (g["init_state"] + rt_zero,
               g["init_cost"] + rt_zero.astype(jnp.float32),
               g["init_off"], g["init_cnt"])
        T_pad = loglikes.shape[0]
        active = jnp.arange(T_pad) < num_frames
        if use_beta:
            ((fs, fc, _, _),), scanned = jax.lax.scan(
                self._frame_step_beta, (tok,), (loglikes, active))
        else:
            if self.L:
                buf = jnp.zeros((T_pad * self.L, self._recw), jnp.int32)
            else:
                buf = jnp.zeros((0,), jnp.int32)
            ((fs, fc, _, _), buf, _), scanned = jax.lax.scan(
                self._frame_step, (tok, buf, jnp.int32(0)),
                (loglikes, active))
        prev, aidxs, dropped, arcs_demand, n_heads, eff_beam = \
            scanned[:6]
        okf = fs >= 0
        fin = self.g["final"][jnp.where(okf, fs, 0)]
        total = jnp.where(okf, fc + fin, INF)
        any_final = jnp.isfinite(total).any()
        fallback = jnp.where(okf, fc, INF)
        use = jnp.where(any_final, total, fallback)
        best_idx = jnp.argmin(use)

        # in-jit Viterbi backtrace: only ONE (T,) sequence ever leaves
        # the device — the winning ARC-INDEX path (tid/olabel are host
        # table lookups; the (T, K) backpointer tensors stay on the
        # device)
        def bt_step(idx, xs):
            prev_t, aidx_t = xs
            i = jnp.maximum(idx, 0)
            live = idx >= 0
            nidx = jnp.where(live, prev_t[i], idx)
            return nidx, jnp.where(live, aidx_t[i], -1)

        bt_end, bt_aidx = jax.lax.scan(
            bt_step, best_idx.astype(jnp.int32), (prev, aidxs),
            reverse=True)
        out = {
            "bt_aidx": bt_aidx, "bt_end": bt_end,
            "dropped_arcs": jnp.sum(dropped),
            # occupancy diagnostics (the reference's beam/max-active
            # warnings role): peak arc demand vs M, peak heads vs K
            "max_arcs_demand": jnp.max(arcs_demand),
            "max_heads": jnp.max(n_heads),
            "min_eff_beam": jnp.min(eff_beam),
            # Σ_t max(0, lattice_beam − eff_beam_t): the integral of
            # budget pressure inside the lattice margin — the
            # escalation trigger (inactive frames report eff_beam =
            # beam ≥ lattice_beam, so they contribute 0)
            "beam_deficit": jnp.sum(jnp.maximum(
                jnp.float32(self.config.lattice_beam) - eff_beam, 0.0)),
            "best_idx": best_idx, "best_cost": use[best_idx],
            "final_cost": jnp.where(any_final, fin[best_idx], 0.0),
            "tok_state": fs, "tok_cost": fc, "tok_final": fin,
            "rec_reversed": jnp.int32(1 if use_beta else 0),
        }
        if use_beta:
            # device β pass (reverse scan over the stacked chunks):
            # only records on complete paths within lattice_beam (+ a
            # small f32 margin) of the best are appended and fetched —
            # the host α/β prune stays the exact f64 authority, this
            # is a superset prefilter that cuts the link bytes ~100×.
            # Segments land in REVERSE frame order (rec_reversed);
            # the host reorders (cheap — the kept set is small).
            chunks, alphas = scanned[6], scanned[7]
            bound = use[best_idx] \
                + jnp.float32(self.config.lattice_beam
                              + self.config.beta_prune_margin)
            beta0 = jnp.where(
                okf, jnp.where(any_final, fin, 0.0), INF)
            # full-size append buffer (appends write L rows at the
            # cursor and must never clamp); the output slices to rcap
            rcap = self.config.record_capacity or (T_pad * self.L)
            buf = jnp.zeros((T_pad * self.L, self._recw), jnp.int32)
            (_, buf, _), cnts = jax.lax.scan(
                partial(self._beta_step, bound),
                (beta0, buf, jnp.int32(0)),
                (chunks, alphas, active), reverse=True)
            out["rec_packed"] = buf[:min(rcap, T_pad * self.L)]
            out["rec_counts"] = cnts
        elif self.L:
            # the cursor-append buffer IS the packed record layout:
            # concatenated per-frame valid prefixes.  A configured
            # record_capacity bounds the device buffer; the host fetch
            # device-slices it to the batch's true record count before
            # the D2H copy (_fetch_batch), so only real records cross
            # the link
            rcap = self.config.record_capacity or (T_pad * self.L)
            out["rec_packed"] = buf[:min(rcap, T_pad * self.L)]
            out["rec_counts"] = scanned[6]
        return out

    # ------------------------------------------------------------------
    # host-side API
    # ------------------------------------------------------------------

    _SMALL_KEYS = ("bt_aidx", "bt_end", "best_cost",
                   "final_cost", "dropped_arcs", "tok_final",
                   "min_eff_beam", "beam_deficit", "rec_reversed")

    def start_fetch(self, out, lattice=False):
        """Begin async device→host copies of everything a later
        _fetch/_fetch_batch will read.  The record tensor itself is
        NOT prefetched: _fetch_batch device-slices it to the batch's
        true record count first (records are cursor-contiguous, so
        rows past n_max are garbage) — a D2H copy cannot start before
        the producing compute finishes either way, so slicing moves
        strictly less data for the same overlap window."""
        for k in self._SMALL_KEYS:
            out[k].copy_to_host_async()
        if lattice:
            out["rec_counts"].copy_to_host_async()

    def _check_overflow(self, n, cap):
        if n > cap:
            raise KaldiError(
                f"BeamDecoder: record_capacity overflow ({n} records > "
                f"{cap}); raise record_capacity or lattice_arcs_per_frame")

    def _fetch(self, out, b=None, lattice=False):
        """Selective device→host fetch for one utterance.  Never pulls
        the (T, L) record tensors: the packed prefix (exactly the valid
        records) and the (T,) sequences are all that crosses the wire."""
        sel = (lambda x: x) if b is None else (lambda x: x[b])
        host = {k: np.asarray(sel(out[k])) for k in self._SMALL_KEYS}
        if lattice:
            counts = np.asarray(sel(out["rec_counts"]))
            n = int(counts.sum())
            self._check_overflow(n, out["rec_packed"].shape[-2])
            host["rec_counts"] = counts
            host["rec_packed"] = np.asarray(sel(out["rec_packed"])[:n])
        return host

    # compaction-bucket granularity: capN rounds up to this many rows
    # so the number of distinct compiled gather programs stays small
    # while the padding waste is ≤ 16384 rows (128 KB) per batch
    _COMPACT_BUCKET = 16384

    def _compact_gather(self, B: int, rcap: int, capN: int):
        """Device-side record compaction: (B, rcap, w) buffer
        + per-utterance counts → ONE (capN, w) array holding each
        utterance's true records back to back.  The D2H copy then
        moves EXACTLY the real records instead of B × batch-max rows
        (batch-max padding is most of the bytes when lengths vary)."""
        key = ("compact", B, rcap, capN)
        fn = self._compiled.get(key)
        if fn is None:
            def gather(buf, ns):
                cum = jnp.concatenate(
                    [jnp.zeros(1, jnp.int32),
                     jnp.cumsum(ns).astype(jnp.int32)])
                r = jnp.arange(capN, dtype=jnp.int32)
                b = jnp.clip(
                    jnp.searchsorted(cum, r, side="right") - 1,
                    0, B - 1)
                off = jnp.clip(r - cum[b], 0, rcap - 1)
                return buf[b, off]

            # a plain jit (not AOT): the record buffer arrives on one
            # device or sharded over a mesh, and jit compiles per input
            # sharding
            fn = jax.jit(gather)
            self._compiled[key] = fn
        return fn

    def _fetch_batch(self, out, batch_size: int, lattice=False):
        """Whole-batch fetch in O(1) device round-trips (per-utterance
        fetches would make the host pass latency-bound).  A failure of
        the device-side compaction raises."""
        import time as _time
        t0 = _time.perf_counter()
        small = jax.device_get({k: out[k] for k in self._SMALL_KEYS})
        hosts = [{k: small[k][b] for k in self._SMALL_KEYS}
                 for b in range(batch_size)]
        if lattice:
            counts = np.asarray(out["rec_counts"])       # (B, T)
            ns = counts.sum(axis=1)          # full B incl. padded rows
            n_max = int(ns.max())
            total = int(ns.sum())
            cap = out["rec_packed"].shape[1]
            self._check_overflow(n_max, cap)
            B = out["rec_packed"].shape[0]
            cum = np.zeros(B + 1, np.int64)
            np.cumsum(ns, out=cum[1:])
            capN = -(-max(total, 1)
                     // self._COMPACT_BUCKET) * self._COMPACT_BUCKET
            # device-side compaction: fetch exactly the real records,
            # not B × batch-max padded rows
            fn = self._compact_gather(B, cap, capN)
            flat = np.asarray(fn(out["rec_packed"],
                                 jnp.asarray(ns, jnp.int32)))
            for b in range(batch_size):
                hosts[b]["rec_counts"] = counts[b]
                hosts[b]["rec_packed"] = flat[cum[b]:cum[b + 1]]
            BUILD_TIMERS.add("fetch_bytes",
                             float(capN * self._recw * 4))
        BUILD_TIMERS.add("fetch_s", _time.perf_counter() - t0)
        return hosts

    # -- demand-triggered escalation (the retry-beam contract) -------------

    def deficit_fires(self, deficit: float) -> bool:
        """THE escalation trigger, shared by every decode surface
        (offline fetch, online finalize, multistream channels, bench
        probes — a single definition so the sites cannot drift): the
        policy is armed (escalate_budget > current budget) and the
        accumulated beam deficit exceeds the threshold."""
        c = self.config
        if not c.escalate_budget or c.escalate_budget <= self.M:
            return False
        return float(deficit) > c.escalate_deficit

    def needs_escalation(self, host) -> bool:
        """True when this utterance's decode should be retried at
        config.escalate_budget: the accumulated beam deficit
        (Σ_t max(0, lattice_beam − eff_beam_t)) says the arc budget
        held the effective beam inside the lattice margin long enough
        to plausibly cost lattice arcs.  Ref:
        src/decoder/decoder-wrappers.h DecodeUtteranceLatticeFaster
        (warn-on-overpruning becomes re-decode-wider here)."""
        return self.deficit_fires(host["beam_deficit"])

    def _escalator(self) -> "BeamDecoder":
        """The sibling decoder escalated utterances re-decode on
        (lazily built; shares this decoder's packed graph)."""
        esc = getattr(self, "_esc", None)
        if esc is None:
            c = self.config
            esc_L = (max(self.L, min(4096, c.escalate_budget))
                     if self.L else 0)
            esc = self.with_overrides(
                arc_budget=c.escalate_budget, escalate_budget=0,
                lattice_arcs_per_frame=esc_L,
                # capacity must still cover the (possibly grown) L —
                # with_overrides enforces record_capacity >= L
                record_capacity=(max(2 * c.record_capacity, esc_L)
                                 if c.record_capacity else 0))
            self._esc = esc
        return esc

    def _get_finalize_beta(self, Tb: int):
        """AOT-compiled device β-prune for STREAMING finalize: reverse
        scan over the online decoder's stored (Tb, L, recw+1) chunk
        and (Tb, K) α buffers → packed kept records (reverse frame
        order) + per-frame counts + total.  Cached per Tb bucket.
        The fetch then ships ~the final lattice instead of every
        within-beam candidate of the whole stream — the finalize
        latency tail was the record fetch.  Compile is AOT from
        abstract shapes so prewarm_finalize_beta can run it in a
        background thread (the first finalize of a new length bucket
        otherwise eats a full cold compile — measured 14 s on the
        p99)."""
        key = ("finbeta", Tb)
        fn = self._compiled.get(key)
        if fn is not None:
            return fn
        fut = getattr(self, "_finbeta_warm", {}).get(Tb)
        if fut is not None:
            return fut.result()
        fn = self._compile_finalize_beta(Tb)
        self._compiled[key] = fn
        return fn

    def _compile_finalize_beta(self, Tb: int):
        K = self.K

        def fb(g, chunks, alphas, n_frames, tok):
            self.g = g
            fs, fc = tok[0], tok[1]
            okf = fs >= 0
            fin = g["final"][jnp.where(okf, fs, 0)]
            total = jnp.where(okf, fc + fin, INF)
            any_final = jnp.isfinite(total).any()
            use = jnp.where(any_final, total,
                            jnp.where(okf, fc, INF))
            bound = jnp.min(use) + jnp.float32(
                self.config.lattice_beam
                + self.config.beta_prune_margin)
            beta0 = jnp.where(
                any_final, jnp.where(okf, fin, INF),
                jnp.where(okf, jnp.float32(0.0), INF))
            active = jnp.arange(Tb) < n_frames
            buf = jnp.zeros((Tb * self.L, self._recw), jnp.int32)
            (_, buf, cursor), cnts = jax.lax.scan(
                partial(self._beta_step, bound),
                (beta0, buf, jnp.int32(0)),
                (chunks, alphas, active), reverse=True)
            return buf, cnts, cursor

        sds = jax.ShapeDtypeStruct
        g_abs = {k: sds(v.shape, v.dtype)
                 for k, v in self._g_host.items()}
        tok_abs = (sds((K,), jnp.int32), sds((K,), jnp.float32),
                   sds((K,), jnp.int32), sds((K,), jnp.int32))
        return jax.jit(fb).lower(
            g_abs, sds((Tb, self.L, self._recw + 1), jnp.int32),
            sds((Tb, K), jnp.float32), sds((), jnp.int32),
            tok_abs).compile()

    def prewarm_finalize_beta(self, Tb: int) -> None:
        """Compile the Tb-bucket finalize β program in a background
        thread (called by the online decoders when a stream crosses
        into a new length bucket, so finalize never pays the cold
        compile)."""
        key = ("finbeta", Tb)
        if key in self._compiled:
            return
        pw = getattr(self, "_finbeta_warm", None)
        if pw is None:
            pw = self._finbeta_warm = {}
        if Tb in pw:
            return
        pw[Tb] = _background(self._compile_finalize_beta, Tb)

    def prewarm_escalator(self, shapes):
        """AOT-compile the escalated sibling's executables for
        ``shapes`` in a background thread, overlapped with base
        decoding.  In the reference, retrying an utterance at a wider
        beam costs nothing (same program, new float); here the wider
        arc budget is a DIFFERENT program whose cold compile runs
        minutes on a big graph — so it is hoisted off the critical
        path at first use.  Returns {shape: Future} (also stored on
        the decoder; _maybe_escalate and harnesses block on the future
        only if an utterance actually escalates before the compile
        lands).  No-op (returns None) when escalation is not armed."""
        c = self.config
        if not c.escalate_budget or c.escalate_budget <= self.M:
            return None
        esc = self._escalator()
        pw = getattr(self, "_esc_prewarm", None) or {}
        for s in shapes:
            if s not in pw:
                pw[s] = _background(esc._get_compiled, s)
        self._esc_prewarm = pw
        return pw

    def _maybe_escalate(self, host, ll_padded: np.ndarray, T: int,
                        lattice: bool = True):
        """Re-decode one utterance at the escalated budget when the
        deficit trigger fires; returns (host, decoder-that-decoded)."""
        if not self.needs_escalation(host):
            return host, self
        esc = self._escalator()
        pw = getattr(self, "_esc_prewarm", None)
        if pw is not None:
            f = pw.get(tuple(np.asarray(ll_padded).shape))
            if f is not None:
                f.result()     # compiled in background; don't race it
        out = esc._decode_jit(esc._graph_arrays(),
                              jnp.asarray(ll_padded, jnp.float32),
                              jnp.int32(T))
        return esc._fetch(out, lattice=lattice), esc

    def decode_compact_batch(self, loglikes_padded: np.ndarray,
                             num_frames: np.ndarray, pool=None,
                             stats: Optional[Dict] = None):
        """(B, T_pad, P) + (B,) → determinized CompactLattices with the
        full production policy: pipelined fetch, demand-triggered
        escalation (config.escalate_budget), and host lattice builds
        optionally fanned over `pool` (the TaskSequencer role).  Pass a
        dict as `stats` to receive min_eff_beam / n_escalated /
        dropped_arcs / peak-occupancy diagnostics (over-pruning must be
        visible)."""
        if not self.L:
            raise KaldiError("decode_compact_batch needs "
                             "lattice_arcs_per_frame")
        B = loglikes_padded.shape[0]
        # escalation retries run per-utterance at (T_pad, P): compile
        # that program in the background while the batch decodes
        self.prewarm_escalator({tuple(loglikes_padded.shape[1:])})
        out = self._decode_batch_jit(
            self._graph_arrays(),
            jnp.asarray(loglikes_padded, jnp.float32),
            jnp.asarray(num_frames, jnp.int32))
        self.start_fetch(out, lattice=True)
        if stats is not None:
            stats.setdefault("min_eff_beam", float("inf"))
            stats.setdefault("n_escalated", 0)
            stats.setdefault("dropped_arcs", 0)
            stats["arcs_peak"] = max(
                stats.get("arcs_peak", 0),
                int(np.asarray(out["max_arcs_demand"]).max()))
            stats["heads_peak"] = max(
                stats.get("heads_peak", 0),
                int(np.asarray(out["max_heads"]).max()))
        hosts = self._fetch_batch(out, B, lattice=True)
        futs = [None] * B
        for b, host in enumerate(hosts):
            T = int(num_frames[b])
            host, dec = self._maybe_escalate(host, loglikes_padded[b], T)
            if stats is not None:
                stats["min_eff_beam"] = min(stats["min_eff_beam"],
                                            float(host["min_eff_beam"]))
                stats["n_escalated"] += int(dec is not self)
                stats["dropped_arcs"] += int(host["dropped_arcs"])
            if pool is None:
                futs[b] = dec.build_compact_lattice(
                    host, T, loglikes_padded[b])
            else:
                futs[b] = pool.submit(dec.build_compact_lattice, host,
                                      T, loglikes_padded[b])
        return [f.result() for f in futs] if pool is not None else futs

    def decode(self, loglikes: np.ndarray
               ) -> Tuple[List[int], List[int], float]:
        """Single utterance → (tid alignment, olabel seq, total cost)."""
        T = loglikes.shape[0]
        out = self._decode_jit(self._graph_arrays(),
                               jnp.asarray(loglikes, jnp.float32),
                               jnp.int32(T))
        return self._backtrace(self._fetch(out), T)

    def decode_batch(self, loglikes_padded: np.ndarray,
                     num_frames: np.ndarray):
        """(B, T_pad, P) + (B,) → list of (tids, olabels, cost)."""
        out = self._decode_batch_jit(
            self._graph_arrays(),
            jnp.asarray(loglikes_padded, jnp.float32),
            jnp.asarray(num_frames, jnp.int32))
        hosts = self._fetch_batch(out, loglikes_padded.shape[0])
        return [self._backtrace(h, int(num_frames[b]))
                for b, h in enumerate(hosts)]

    def decode_lattice(self, loglikes: np.ndarray) -> Lattice:
        """Single utterance → pruned raw Lattice (GetRawLattice +
        lattice-beam pruning).  Requires lattice_arcs_per_frame > 0."""
        if not self.L:
            raise KaldiError("decode_lattice needs lattice_arcs_per_frame")
        T = loglikes.shape[0]
        out = self._decode_jit(self._graph_arrays(),
                               jnp.asarray(loglikes, jnp.float32),
                               jnp.int32(T))
        host, dec = self._maybe_escalate(self._fetch(out, lattice=True),
                                         loglikes, T)
        return dec._build_lattice(host, T, loglikes)

    def decode_compact(self, loglikes: np.ndarray, bucket: int = 64,
                       max_states: int = 200000):
        """Single utterance → determinized CompactLattice via the fused
        native build+determinize path (the decode-wrappers contract:
        lattices on disk are determinized).  Frame count is padded up
        to a `bucket` multiple so a stream of mixed-length utterances
        reuses a handful of compiled shapes (padded frames are masked
        by num_frames inside the scan)."""
        if not self.L:
            raise KaldiError("decode_compact needs lattice_arcs_per_frame")
        T = loglikes.shape[0]
        ll = np.asarray(loglikes, np.float32)
        if bucket > 1 and T % bucket:
            pad = bucket - T % bucket
            ll = np.concatenate(
                [ll, np.zeros((pad, ll.shape[1]), np.float32)])
        self.prewarm_escalator({tuple(ll.shape)})
        out = self._decode_jit(self._graph_arrays(),
                               jnp.asarray(ll), jnp.int32(T))
        host, dec = self._maybe_escalate(self._fetch(out, lattice=True),
                                         ll, T)
        return dec.build_compact_lattice(host, T, ll,
                                         max_states=max_states)

    def decode_lattice_batch(self, loglikes_padded: np.ndarray,
                             num_frames: np.ndarray) -> List[Lattice]:
        if not self.L:
            raise KaldiError("decode_lattice needs lattice_arcs_per_frame")
        out = self._decode_batch_jit(
            self._graph_arrays(),
            jnp.asarray(loglikes_padded, jnp.float32),
            jnp.asarray(num_frames, jnp.int32))
        hosts = self._fetch_batch(out, loglikes_padded.shape[0],
                                  lattice=True)
        lats = []
        for b, h in enumerate(hosts):
            T = int(num_frames[b])
            h, dec = self._maybe_escalate(h, loglikes_padded[b], T)
            lats.append(dec._build_lattice(h, T, loglikes_padded[b]))
        return lats

    # -- Viterbi backtrace -------------------------------------------------

    def _backtrace(self, host, T: int):
        best_cost = float(host["best_cost"])
        if not np.isfinite(best_cost):
            raise KaldiError("BeamDecoder: no tokens survived")
        start_slot = int(host["bt_end"])
        if start_slot < 0:
            raise KaldiError("BeamDecoder: broken backpointer chain")
        aidx = np.asarray(host["bt_aidx"][:T])
        aidx = aidx[aidx >= 0]
        tids = [int(t) for t in self._flat[aidx, 2] if t]
        ols = list(self._expand_ol(int(self._init_ols[start_slot])))
        for o in self._flat[aidx, 4]:
            if o:
                ols.extend(self._expand_ol(int(o)))
        return tids, ols, best_cost

    def _expand_ol(self, ol: int):
        from kaldi_tpu.fst.csr import expand_olabel
        return expand_olabel(ol, self._ol_seqs)

    # -- lattice assembly (vectorized, no per-arc Python) ------------------

    def _decode_records(self, host, T: int, loglikes: np.ndarray):
        """Decode the packed 2-word device records into flat arc-field
        arrays: (counts, prev, dst, il, ol, gw, ac, init_slots,
        init_costs).  il/ol/gw/pdf come from the host arc table by arc
        index; acoustic cost is recomputed from the host loglikes (f32
        multiply — bit-identical to the device value)."""
        counts = host["rec_counts"][:T]
        packed = host["rec_packed"]
        if int(host.get("rec_reversed", 0)):
            # the device β pass appends frame segments in REVERSE
            # order; restore forward order (vectorized index build —
            # the β-pruned set is small)
            counts = np.asarray(counts, np.int64)
            n = int(counts.sum())
            packed = packed[:n]
            fwd_offs = np.zeros(T + 1, np.int64)
            np.cumsum(counts, out=fwd_offs[1:])
            starts_rev = n - fwd_offs[1:]
            delta = np.repeat(starts_rev - fwd_offs[:-1], counts)
            packed = packed[np.arange(n) + delta]
        if self._pack_pd:
            r_prev = packed[:, 0] >> self._tok_bits
            r_dst = packed[:, 0] & ((1 << self._tok_bits) - 1)
            aidx = packed[:, 1]
        else:
            r_prev, r_dst, aidx = (packed[:, 0], packed[:, 1],
                                   packed[:, 2])
        flat = self._flat
        r_il = flat[aidx, 2]
        r_ol = flat[aidx, 4]
        r_gw = flat[aidx, 1].view(np.float32)
        t_of = np.repeat(np.arange(T), counts)
        ll = np.asarray(loglikes, np.float32)
        r_ac = np.float32(-self.config.acoustic_scale) \
            * ll[t_of, flat[aidx, 3]]
        init_cost = self._g_host["init_cost"]
        init_slots = np.nonzero(np.isfinite(init_cost))[0].astype(np.int32)
        return (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
                init_slots, init_cost[init_slots],
                self._init_ols[init_slots].astype(np.int32))

    def _expand_arc_ols(self, ks, kd, kil, kol, kgw, kac, n_states):
        """Split arcs whose olabel is sequence-encoded (>= OLSEQ_BASE)
        into chains through fresh states, one plain word olabel per
        arc, BEFORE determinization — so the determinized lattice is
        canonical over true word sequences.  No-op when the graph has
        no encoded olabels."""
        from kaldi_tpu.fst.csr import OLSEQ_BASE
        if not self._ol_seqs or not len(kol):
            return ks, kd, kil, kol, kgw, kac, n_states
        enc = np.nonzero(np.asarray(kol) >= OLSEQ_BASE)[0]
        if not len(enc):
            return ks, kd, kil, kol, kgw, kac, n_states
        ks = list(np.asarray(ks)); kd = list(np.asarray(kd))
        kil = list(np.asarray(kil)); kol = list(np.asarray(kol))
        kgw = list(np.asarray(kgw)); kac = list(np.asarray(kac))
        for i in enc:
            seq = self._ol_seqs[int(kol[i]) - OLSEQ_BASE]
            dst = kd[i]
            # first word rides the original (emitting) arc; the rest
            # follow on fresh ε-input arcs
            kol[i] = seq[0]
            prev = n_states
            kd[i] = prev
            n_states += len(seq) - 1
            for j, wid in enumerate(seq[1:]):
                last = j == len(seq) - 2
                ks.append(prev); kd.append(dst if last else prev + 1)
                kil.append(0); kol.append(wid)
                kgw.append(0.0); kac.append(0.0)
                prev += 1
        return (np.asarray(ks, np.int32), np.asarray(kd, np.int32),
                np.asarray(kil, np.int32), np.asarray(kol, np.int32),
                np.asarray(kgw, np.float32), np.asarray(kac, np.float32),
                n_states)

    def build_compact_lattice(self, host, T: int, loglikes: np.ndarray,
                              max_states: int = 200000):
        """Records → determinized CompactLattice with both hot passes
        native (the fused GetRawLattice +
        DeterminizeLatticePhonePrunedWrapper contract): the raw
        state-level lattice never exists as Python objects.  Falls
        back to _build_lattice + determinize_lattice when the native
        library is unavailable."""
        import time as _time

        from kaldi_tpu import native
        from kaldi_tpu.lattice.determinize import (compact_from_arrays,
                                                   determinize_lattice)
        t0 = _time.perf_counter()
        (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
         init_slots, init_costs, init_ols) = \
            self._decode_records(host, T, loglikes)
        t1 = _time.perf_counter()
        BUILD_TIMERS.add("records_s", t1 - t0)
        res = native.build_lattice_native(
            counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
            init_slots, init_costs, init_ols, host["tok_final"],
            self.config.lattice_beam)
        t2 = _time.perf_counter()
        BUILD_TIMERS.add("raw_build_s", t2 - t1)
        if res is not None:
            (ks, kd, kil, kol, kgw, kac, fs, fw, n_kept) = res
            (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
                ks, kd, kil, kol, kgw, kac, n_kept)
            det = native.determinize_lattice_native(
                n_kept, 0, ks, kd, kil, kol, kgw, kac,
                fs, fw, np.zeros(len(fw), np.float32),
                max_states=max_states)
            BUILD_TIMERS.add("determinize_s",
                             _time.perf_counter() - t2)
            if det is not None:
                return compact_from_arrays(det)
        return determinize_lattice(self._build_lattice(host, T, loglikes),
                                   max_states=max_states)

    def _build_lattice(self, host, T: int,
                       loglikes: np.ndarray) -> Lattice:
        K = self.K
        beam = self.config.lattice_beam
        (counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
         init_slots, init_costs, init_ols) = \
            self._decode_records(host, T, loglikes)
        offs = np.zeros(T + 1, np.int64)
        np.cumsum(counts, out=offs[1:])

        # native C++ fast path (kaldi_tpu/native/lattice_build.cpp);
        # the numpy pass below is the oracle and fallback
        from kaldi_tpu import native
        res = native.build_lattice_native(
            counts, r_prev, r_dst, r_il, r_ol, r_gw, r_ac,
            init_slots, init_costs, init_ols, host["tok_final"], beam)
        if res is not None:
            (ks, kd, kil, kol, kgw, kac, fs, fw, n_kept) = res
            (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
                ks, kd, kil, kol, kgw, kac, n_kept)
            lat = Lattice()
            for _ in range(n_kept):
                lat.add_state()
            lat.start = 0
            for i in range(len(ks)):
                lat.arcs[ks[i]].append(LatticeArc(
                    int(kil[i]), int(kol[i]), float(kgw[i]),
                    float(kac[i]), int(kd[i])))
            for s, wgt in zip(fs, fw):
                lat.set_final(int(s), float(wgt), 0.0)
            return lat

        # level 0: the initial token set, connected from a virtual start
        init_cost = self._g_host["init_cost"]
        init_slots = np.nonzero(np.isfinite(init_cost))[0]
        cur = np.full(K, -1, np.int64)
        cur[init_slots] = 1 + np.arange(len(init_slots))
        n_states = 1 + len(init_slots)
        arcs_src: List[np.ndarray] = [np.zeros(len(init_slots), np.int64)]
        arcs_dst: List[np.ndarray] = [cur[init_slots]]
        arcs_il: List[np.ndarray] = [np.zeros(len(init_slots), np.int32)]
        arcs_ol: List[np.ndarray] = [
            self._init_ols[init_slots].astype(np.int32)]
        arcs_gw: List[np.ndarray] = [init_cost[init_slots]]
        arcs_ac: List[np.ndarray] = [np.zeros(len(init_slots), np.float32)]
        level_sizes: List[int] = [len(init_slots)]
        for t in range(T):
            sl = slice(offs[t], offs[t + 1])
            prev = r_prev[sl]
            valid = cur[prev] >= 0
            dst = r_dst[sl][valid]
            uniq = np.unique(dst)
            new = np.full(K, -1, np.int64)
            new[uniq] = n_states + np.arange(len(uniq))
            n_states += len(uniq)
            arcs_src.append(cur[prev[valid]])
            arcs_dst.append(new[dst])
            arcs_il.append(r_il[sl][valid])
            arcs_ol.append(r_ol[sl][valid])
            arcs_gw.append(r_gw[sl][valid])
            arcs_ac.append(r_ac[sl][valid])
            level_sizes.append(int(valid.sum()))
            cur = new
        src = np.concatenate(arcs_src)
        dst = np.concatenate(arcs_dst)
        il = np.concatenate(arcs_il)
        ol = np.concatenate(arcs_ol)
        gw = np.concatenate(arcs_gw).astype(np.float64)
        ac = np.concatenate(arcs_ac).astype(np.float64)
        w = gw + ac

        fin_slots = np.nonzero((cur >= 0)
                               & np.isfinite(host["tok_final"]))[0]
        fin_states = cur[fin_slots]
        fin_w = host["tok_final"][fin_slots].astype(np.float64)
        if len(fin_states) == 0:   # no token reached a final state
            fin_states = cur[np.nonzero(cur >= 0)[0]]
            fin_w = np.zeros(len(fin_states))

        alpha = np.full(n_states, np.inf)
        alpha[0] = 0.0
        pos = 0
        for n in level_sizes:
            sl = slice(pos, pos + n)
            np.minimum.at(alpha, dst[sl], alpha[src[sl]] + w[sl])
            pos += n
        beta = np.full(n_states, np.inf)
        np.minimum.at(beta, fin_states, fin_w)
        pos = len(src)
        for n in reversed(level_sizes):
            sl = slice(pos - n, pos)
            np.minimum.at(beta, src[sl], w[sl] + beta[dst[sl]])
            pos -= n
        best = alpha[fin_states] + fin_w
        if not len(best) or not np.isfinite(best.min()):
            raise KaldiError("BeamDecoder: empty lattice")
        bound = best.min() + beam

        keep_arc = alpha[src] + w + beta[dst] <= bound
        keep_state = np.zeros(n_states, bool)
        keep_state[0] = True
        keep_state[src[keep_arc]] = True
        keep_state[dst[keep_arc]] = True
        remap = np.cumsum(keep_state) - 1

        ks = remap[src[keep_arc]]
        kd = remap[dst[keep_arc]]
        kil = il[keep_arc]
        kol = ol[keep_arc]
        kgw = gw[keep_arc]
        kac = ac[keep_arc]
        n_kept = int(keep_state.sum())
        (ks, kd, kil, kol, kgw, kac, n_kept) = self._expand_arc_ols(
            ks, kd, kil, kol, kgw, kac, n_kept)
        lat = Lattice()
        for _ in range(n_kept):
            lat.add_state()
        lat.start = 0
        for i in range(len(ks)):
            lat.arcs[ks[i]].append(LatticeArc(
                int(kil[i]), int(kol[i]), float(kgw[i]), float(kac[i]),
                int(kd[i])))
        fk = keep_state[fin_states] & (alpha[fin_states] + fin_w <= bound)
        for s, wgt in zip(fin_states[fk], fin_w[fk]):
            lat.set_final(int(remap[s]), float(wgt), 0.0)
        return lat
