"""Lattice-derived chain supervision (numerator FSAs).

Parity target: src/chain/chain-supervision.{h,cc} — the reference
builds each utterance's numerator graph from a LATTICE of alternatives
(alternative pronunciations/alignments from lattice-align-phones), not
a single forced alignment: every lattice path is an allowed phone
sequence, and each phone's start/end may move within ±tolerance frames
of its lattice time (ProtoSupervision → Supervision FST).

Encoding: the supervision FSA stays ARC-synchronous — trellis
nodes are lattice phone arcs (being "inside" that phone), and the time
tolerance becomes a per-frame mask computed from each state's boundary
frame, so the whole forward is one lax.scan of
gather + segment-logsumexp steps over padded arc tensors (the same
shape as the denominator forward in am/chain.py, but with per-sequence
graphs).  The linear-chain flexible numerator
(chain.numerator_flexible_logprob) is the special case of a one-path
lattice with unbounded tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.lattice.functions import state_times
from kaldi_tpu.lattice.lattice import CompactLattice

log = get_logger(__name__)

NEG = -1e30


@dataclasses.dataclass
class SupervisionFsa:
    """One utterance's numerator graph at the (subsampled) frame rate.

    Arc a models one phone occurrence: entering it at frame t emits
    entry_pdf[a], staying emits self_pdf[a].  bt[s] is state s's
    boundary frame from the lattice; entering an arc at frame t is
    allowed iff |t − bt[src]| ≤ tolerance, and a path may end in arc a
    at the sequence end iff |T − bt[dst]| ≤ tolerance."""
    src: np.ndarray          # (A,) int32
    dst: np.ndarray          # (A,) int32
    entry_pdf: np.ndarray    # (A,) int32
    self_pdf: np.ndarray     # (A,) int32
    weight: np.ndarray       # (A,) f32 log-space entry weight
    bt: np.ndarray           # (S,) int32 boundary frames
    start: int
    final: np.ndarray        # (S,) bool
    num_frames: int          # T at the subsampled rate
    phone: Optional[np.ndarray] = None     # (A,) phone of each arc
    self_w: Optional[np.ndarray] = None    # (A,) per-self-frame weight
    final_w: Optional[np.ndarray] = None   # (A,) end-of-sequence weight
    # chunk-boundary flags (chunk_supervision): start/end mid-utterance
    mid_start: bool = False
    mid_end: bool = False

    @property
    def num_states(self) -> int:
        return len(self.bt)


def supervision_from_phone_runs(
        paths: Sequence[Sequence[Tuple[int, int]]],
        path_weights: Sequence[float],
        entry_pdf_of, self_pdf_of, num_frames: int) -> SupervisionFsa:
    """Build a supervision FSA as a union of alternative phone paths
    (each a [(phone, duration)] run list covering num_frames).  The
    general entry point: lattice paths, pronunciation alternatives, or
    a single forced alignment all reduce to this."""
    srcs: List[int] = []
    dsts: List[int] = []
    epdf: List[int] = []
    spdf: List[int] = []
    wgt: List[float] = []
    phn: List[int] = []
    bt: List[int] = [0]
    final: List[bool] = [False]
    start = 0
    # share states across paths by boundary-time prefix?  Keep it
    # simple and exact: each path is its own chain; the forward over
    # the union IS logsumexp over paths (tested against enumeration).
    for path, pw in zip(paths, path_weights):
        tot = sum(d for _, d in path)
        if tot != num_frames:
            raise KaldiError(
                f"path covers {tot} frames, utterance has {num_frames}")
        cur = start
        t = 0
        for k, (phone, dur) in enumerate(path):
            t += dur
            nxt = len(bt)
            bt.append(t)
            final.append(k == len(path) - 1)
            srcs.append(cur)
            dsts.append(nxt)
            epdf.append(entry_pdf_of(phone))
            spdf.append(self_pdf_of(phone))
            wgt.append(pw if k == 0 else 0.0)
            phn.append(phone)
            cur = nxt
    return SupervisionFsa(
        src=np.asarray(srcs, np.int32), dst=np.asarray(dsts, np.int32),
        entry_pdf=np.asarray(epdf, np.int32),
        self_pdf=np.asarray(spdf, np.int32),
        weight=np.asarray(wgt, np.float32),
        bt=np.asarray(bt, np.int32), start=start,
        final=np.asarray(final, bool), num_frames=num_frames,
        phone=np.asarray(phn, np.int32))


def supervision_from_text(phones: Sequence[int], entry_pdf_of,
                          self_pdf_of,
                          num_frames: int) -> SupervisionFsa:
    """End-to-end (flat-start) supervision: the transcript's phone
    sequence with FREE boundary times (chain-supervision.h's
    e2e/TrainingGraphToSupervision role — egs/wsj run_e2e flat-start
    chain trains with no prior alignment).  The uniform durations
    below only seed the bt placeholders; run the numerator with
    tolerance ≥ num_frames so every boundary window is vacuous and
    ALL monotone alignments of the sequence (each phone ≥ 1 frame)
    are in the FSA."""
    n = len(phones)
    if n == 0 or n > num_frames:
        raise KaldiError(f"supervision_from_text: {n} phones cannot "
                         f"fill {num_frames} frames")
    base, rem = divmod(num_frames, n)
    runs = [(int(p), base + (1 if i < rem else 0))
            for i, p in enumerate(phones)]
    return supervision_from_phone_runs([runs], [0.0], entry_pdf_of,
                                       self_pdf_of, num_frames)


def supervision_from_lattice(clat: CompactLattice, tm,
                             entry_pdf_of, self_pdf_of,
                             subsample: int = 3,
                             acoustic_scale: float = 0.0
                             ) -> SupervisionFsa:
    """Phone-aligned CompactLattice → supervision FSA: every lattice
    path is an allowed alignment; arc tid strings are split into phone
    runs (SplitToPhones semantics) and boundaries land at the
    subsampled rate.  With acoustic_scale=0 all alternatives weigh by
    graph cost only (the reference drops lattice weights entirely;
    keep 0.0 for parity, nonzero to weight alternatives)."""
    times = state_times(clat)
    srcs: List[int] = []
    dsts: List[int] = []
    epdf: List[int] = []
    spdf: List[int] = []
    wgt: List[float] = []
    phn: List[int] = []
    # supervision state per (lattice state): boundary at its time
    bt: List[int] = [t // subsample for t in times]
    final = [s in clat.finals for s in range(clat.num_states)]
    from kaldi_tpu.pipelines.chain import phone_alignment_runs
    for s in range(clat.num_states):
        for a in clat.arcs[s]:
            runs = phone_alignment_runs(tm, a.tids)
            w = -(a.graph_cost + acoustic_scale * a.acoustic_cost)
            t = times[s]
            cur = s
            for k, (phone, dur) in enumerate(runs):
                t += dur
                if k == len(runs) - 1:
                    nxt = a.nextstate
                else:
                    nxt = len(bt)
                    bt.append(t // subsample)
                    final.append(False)
                srcs.append(cur)
                dsts.append(nxt)
                epdf.append(entry_pdf_of(phone))
                spdf.append(self_pdf_of(phone))
                wgt.append(w if k == 0 else 0.0)
                phn.append(phone)
                cur = nxt
    T = max(times[s] for s in clat.finals) // subsample
    return SupervisionFsa(
        src=np.asarray(srcs, np.int32), dst=np.asarray(dsts, np.int32),
        entry_pdf=np.asarray(epdf, np.int32),
        self_pdf=np.asarray(spdf, np.int32),
        weight=np.asarray(wgt, np.float32),
        bt=np.asarray(bt, np.int32), start=clat.start,
        final=np.asarray(final, bool), num_frames=T,
        phone=np.asarray(phn, np.int32))


def chunk_supervision(fsa: SupervisionFsa, c0: int, c1: int
                      ) -> SupervisionFsa:
    """Restrict a supervision FSA to frames [c0, c1) (the fixed-chunk
    cutting of get_egs.sh).  Boundary times shift by −c0; arcs whose
    time window cannot intersect the chunk are dropped.  A chunk that
    starts (ends) mid-utterance marks mid_start (mid_end): the forward
    may then begin inside any arc alive at the boundary and finish in
    any arc alive at the end, matching the reference's chunk-boundary
    semantics (supervision need not begin at the utterance start or
    reach a final state)."""
    T = c1 - c0
    keep = []
    for a in range(len(fsa.src)):
        lo = int(fsa.bt[fsa.src[a]]) - c0
        hi = int(fsa.bt[fsa.dst[a]]) - c0
        if hi < 0 or lo > T:
            continue
        keep.append(a)
    keep = np.asarray(keep, np.int64)
    # states renumber densely over the kept arcs (+ start)
    used = sorted(set(fsa.src[keep].tolist())
                  | set(fsa.dst[keep].tolist()) | {fsa.start})
    remap = {s: i for i, s in enumerate(used)}
    return SupervisionFsa(
        src=np.asarray([remap[s] for s in fsa.src[keep]], np.int32),
        dst=np.asarray([remap[s] for s in fsa.dst[keep]], np.int32),
        entry_pdf=fsa.entry_pdf[keep], self_pdf=fsa.self_pdf[keep],
        weight=fsa.weight[keep],
        bt=np.asarray([int(fsa.bt[s]) - c0 for s in used], np.int32),
        start=remap[fsa.start],
        final=np.asarray([bool(fsa.final[s]) for s in used]),
        num_frames=T,
        phone=None if fsa.phone is None else fsa.phone[keep],
        self_w=None if fsa.self_w is None else fsa.self_w[keep],
        final_w=(np.zeros(len(keep), np.float32)
                 if fsa.final_w is not None else None),
        mid_start=c0 > 0, mid_end=c1 < fsa.num_frames)


def add_normalization_weights(fsa: SupervisionFsa, den
                              ) -> SupervisionFsa:
    """Compose the supervision FSA with the denominator's
    normalization weights (chain-supervision.h
    AddWeightToSupervisionFst): every arc gains the den graph's
    phone-LM + topology log-probs, making numerator − denominator a
    properly normalized (≤ 0) log-likelihood ratio.

    Weights depend on the phone HISTORY, so states are expanded to
    (supervision state, den LM state) pairs — lattice states that merge
    different histories split, exactly as the reference's FST
    composition does."""
    lm = den.lm
    if lm is None or fsa.phone is None:
        raise KaldiError("add_normalization_weights needs a den graph "
                         "with its PhoneLm and an FSA with phones")
    # per-LM-state weight views (CD den graphs expand states by left
    # phone; normalization weights walk LM states — see norm_view)
    nv_init, nv_self, nv_fwd, nv_final = den.norm_view()
    pidx = {p: i for i, p in enumerate(lm.phones)}
    out_arcs: List[Tuple[int, int, int, int, float, float, float, int]] \
        = []   # (src', dst', epdf, spdf, entry_w, self_w, final_w, phn)
    bt: List[int] = []
    final: List[bool] = []
    state_map: Dict[Tuple[int, int], int] = {}

    def new_state(s: int, lmst: int) -> int:
        key = (s, lmst)
        if key not in state_map:
            state_map[key] = len(bt)
            bt.append(int(fsa.bt[s]))
            final.append(bool(fsa.final[s]))
        return state_map[key]

    arcs_out: Dict[int, List[int]] = {}
    for a in range(len(fsa.src)):
        arcs_out.setdefault(int(fsa.src[a]), []).append(a)

    start = new_state(fsa.start, -1)     # -1 = no phone yet
    stack = [(fsa.start, -1)]
    seen = {(fsa.start, -1)}
    while stack:
        s, lmst = stack.pop()
        sid = state_map[(s, lmst)]
        for a in arcs_out.get(s, []):
            c = pidx[int(fsa.phone[a])]
            if lmst < 0:
                nl = lm.state_of((int(fsa.phone[a]),))
                ew = float(nv_init[nl])
            else:
                nl = int(lm.next_state[lmst, c])
                ew = float(nv_fwd[lmst] + lm.next_logp[lmst, c])
            d = int(fsa.dst[a])
            did = new_state(d, nl)
            out_arcs.append((
                sid, did, int(fsa.entry_pdf[a]), int(fsa.self_pdf[a]),
                float(fsa.weight[a]) + ew, float(nv_self[nl]),
                float(nv_final[nl]) if fsa.final[d] else 0.0,
                int(fsa.phone[a])))
            if (d, nl) not in seen:
                seen.add((d, nl))
                stack.append((d, nl))
    arr = list(zip(*out_arcs))
    return SupervisionFsa(
        src=np.asarray(arr[0], np.int32), dst=np.asarray(arr[1], np.int32),
        entry_pdf=np.asarray(arr[2], np.int32),
        self_pdf=np.asarray(arr[3], np.int32),
        weight=np.asarray(arr[4], np.float32),
        bt=np.asarray(bt, np.int32), start=start,
        final=np.asarray(final, bool), num_frames=fsa.num_frames,
        phone=np.asarray(arr[7], np.int32),
        self_w=np.asarray(arr[5], np.float32),
        final_w=np.asarray(arr[6], np.float32))


def pack_supervisions(fsas: Sequence[SupervisionFsa]
                      ) -> Dict[str, np.ndarray]:
    """Pad a batch of FSAs to common (A_max, S_max) tensors for the
    batched forward."""
    B = len(fsas)
    A = max(len(f.src) for f in fsas)
    S = max(f.num_states for f in fsas)
    out = {
        "src": np.zeros((B, A), np.int32),
        "dst": np.zeros((B, A), np.int32),
        "entry_pdf": np.zeros((B, A), np.int32),
        "self_pdf": np.zeros((B, A), np.int32),
        "weight": np.full((B, A), NEG, np.float32),
        "self_w": np.zeros((B, A), np.float32),
        "final_w": np.zeros((B, A), np.float32),
        "bt": np.zeros((B, S), np.int32),
        "start": np.zeros(B, np.int32),
        "final": np.zeros((B, S), bool),
        "num_frames": np.zeros(B, np.int32),
        "num_states": np.full(B, S, np.int32),
        "n_arcs": np.zeros(B, np.int32),
        "n_states": np.zeros(B, np.int32),
        "mid_start": np.zeros(B, bool),
        "mid_end": np.zeros(B, bool),
    }
    for b, f in enumerate(fsas):
        a, s = len(f.src), f.num_states
        out["src"][b, :a] = f.src
        out["dst"][b, :a] = f.dst
        out["entry_pdf"][b, :a] = f.entry_pdf
        out["self_pdf"][b, :a] = f.self_pdf
        out["weight"][b, :a] = f.weight
        if f.self_w is not None:
            out["self_w"][b, :a] = f.self_w
        if f.final_w is not None:
            out["final_w"][b, :a] = f.final_w
        out["bt"][b, :s] = f.bt
        # padding arcs self-loop on a dead state with weight −inf
        out["src"][b, a:] = S - 1 if s < S else f.src[0]
        out["dst"][b, a:] = S - 1 if s < S else f.dst[0]
        out["start"][b] = f.start
        out["final"][b, :s] = f.final
        out["num_frames"][b] = f.num_frames
        out["n_arcs"][b] = a
        out["n_states"][b] = s
        out["mid_start"][b] = f.mid_start
        out["mid_end"][b] = f.mid_end
    return out


def make_chain_egs_from_lattices(
        feats: Dict[str, np.ndarray], lattices: Dict[str, CompactLattice],
        tm, tree, topo, subsample: int = 3, den=None,
        chunk_size: Optional[int] = None):
    """Whole-utterance chain egs with lattice-derived supervision
    (the get_egs.sh path that consumes alignment LATTICES rather than
    single best alignments).  Returns a ChainEgs whose `sup` field
    carries the packed supervision FSAs; feats are padded to the batch
    max and masked.  Pass the DenominatorGraph as `den` to compose the
    normalization weights in (objf ≤ 0 contract)."""
    from kaldi_tpu.pipelines.chain import ChainEgs

    def pdfs_for(phone, is_entry):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        st = topo.topology_for_phone(phone)[0]
        cls = (st.forward_pdf_class if is_entry
               else st.self_loop_pdf_class)
        return tree.compute(window, cls)

    utts = sorted(lattices)
    fsas = [supervision_from_lattice(
        lattices[u], tm, lambda p: pdfs_for(p, True),
        lambda p: pdfs_for(p, False), subsample=subsample)
        for u in utts]
    if den is not None:
        fsas = [add_normalization_weights(f, den) for f in fsas]
    # chunk_size (subsampled frames): cut each utterance into
    # fixed-size chunks like get_egs.sh (remainders < chunk_size/2 are
    # dropped, matching its min-chunk behaviour)
    pieces: List[Tuple[SupervisionFsa, np.ndarray]] = []
    for f, u in zip(fsas, utts):
        if chunk_size is None:
            pieces.append((f, feats[u]))
            continue
        c = 0
        while c < f.num_frames:
            c1 = min(c + chunk_size, f.num_frames)
            if c1 - c >= max(chunk_size // 2, 1):
                pieces.append((chunk_supervision(f, c, c1),
                               feats[u][c * subsample:c1 * subsample]))
            c = c1
    sub_fsas = [p[0] for p in pieces]
    # the model subsamples time ×subsample before scoring, so scores
    # and mask must share T_sub exactly: clamp feats to T_sub·subsample
    T_sub = max(f.num_frames for f in sub_fsas)
    T_full = T_sub * subsample
    D = next(iter(feats.values())).shape[1]
    N = len(pieces)
    fpad = np.zeros((N, T_full, D), np.float32)
    mask = np.zeros((N, T_sub), bool)
    for i, (f, x) in enumerate(pieces):
        fl = min(x.shape[0], T_full)
        fpad[i, :fl] = x[:fl]
        mask[i, :f.num_frames] = True
    return ChainEgs(feats=fpad,
                    pdf_ali=np.zeros((N, T_sub), np.int32),
                    mask=mask, sup=pack_supervisions(sub_fsas))


def make_chain_egs_e2e(feats: Dict[str, np.ndarray],
                       phone_seqs: Dict[str, Sequence[int]],
                       tree, topo, subsample: int = 3, den=None):
    """Whole-utterance END-TO-END chain egs (flat-start: no prior
    alignment; egs/wsj run_e2e / chainbin nnet3-chain-e2e-get-egs
    role): supervision = the transcript's phone sequence with free
    boundaries.  Train with supervision_tolerance >= the longest
    utterance (ChainTrainConfig) so the boundary windows are vacuous.
    Returns a ChainEgs whose `sup` carries the packed FSAs."""
    from kaldi_tpu.pipelines.chain import ChainEgs

    def pdfs_for(phone, is_entry):
        window = [0] * tree.context_width
        window[tree.central_position] = phone
        st = topo.topology_for_phone(phone)[0]
        cls = (st.forward_pdf_class if is_entry
               else st.self_loop_pdf_class)
        return tree.compute(window, cls)

    utts = sorted(phone_seqs)
    fsas = []
    for u in utts:
        T_sub = feats[u].shape[0] // subsample
        fsas.append(supervision_from_text(
            phone_seqs[u], lambda p: pdfs_for(p, True),
            lambda p: pdfs_for(p, False), T_sub))
    if den is not None:
        fsas = [add_normalization_weights(f, den) for f in fsas]
    T_sub_max = max(f.num_frames for f in fsas)
    T_full = T_sub_max * subsample
    D = next(iter(feats.values())).shape[1]
    N = len(utts)
    fpad = np.zeros((N, T_full, D), np.float32)
    mask = np.zeros((N, T_sub_max), bool)
    for i, (f, u) in enumerate(zip(fsas, utts)):
        fl = min(feats[u].shape[0], T_full)
        fpad[i, :fl] = feats[u][:fl]
        mask[i, :f.num_frames] = True
    return ChainEgs(feats=fpad,
                    pdf_ali=np.zeros((N, T_sub_max), np.int32),
                    mask=mask, sup=pack_supervisions(fsas))


def _batched_segment_logsumexp(vals: jnp.ndarray, segs: jnp.ndarray,
                               num_segments: int) -> jnp.ndarray:
    """vals (B, A), segs (B, A) int → (B, num_segments): per-row
    segment logsumexp via flattened offset ids."""
    B, A = vals.shape
    flat_segs = (segs + jnp.arange(B, dtype=segs.dtype)[:, None]
                 * num_segments).reshape(-1)
    flat = vals.reshape(-1)
    mx = jnp.full(B * num_segments, jnp.float32(NEG))
    mx = mx.at[flat_segs].max(flat)
    s = jnp.zeros(B * num_segments)
    s = s.at[flat_segs].add(jnp.exp(flat - mx[flat_segs]))
    out = mx + jnp.log(jnp.maximum(s, 1e-30))
    return out.reshape(B, num_segments)


def numerator_fsa_logprob(scores: jnp.ndarray, sup: Dict[str, jnp.ndarray],
                          tolerance: int = 0) -> jnp.ndarray:
    """Forward log-prob of each sequence through its supervision FSA.

    scores (B, T, P) log acoustic scores at the subsampled rate; sup =
    pack_supervisions output (device arrays ok).  Time tolerance t
    lets every phone boundary move ±t frames from its lattice time
    (chain-supervision's left/right tolerance).  Returns (B,)."""
    src = jnp.asarray(sup["src"])
    dst = jnp.asarray(sup["dst"])
    entry_pdf = jnp.asarray(sup["entry_pdf"])
    self_pdf = jnp.asarray(sup["self_pdf"])
    weight = jnp.asarray(sup["weight"])
    self_w = (jnp.asarray(sup["self_w"]) if "self_w" in sup
              else jnp.zeros_like(weight))
    final_w = (jnp.asarray(sup["final_w"]) if "final_w" in sup
               else jnp.zeros_like(weight))
    bt = jnp.asarray(sup["bt"])
    start = jnp.asarray(sup["start"])
    final = jnp.asarray(sup["final"])
    num_frames = jnp.asarray(sup["num_frames"])
    B, T, P = scores.shape
    S = bt.shape[1]
    tol = tolerance

    bt_src = jnp.take_along_axis(bt, src, axis=1)        # (B, A)
    bt_dst = jnp.take_along_axis(bt, dst, axis=1)
    is_start = jnp.take_along_axis(
        start[:, None] == jnp.arange(S)[None, :], src, axis=1)
    mid_start = jnp.asarray(sup["mid_start"]) if "mid_start" in sup \
        else jnp.zeros(B, bool)
    mid_end = jnp.asarray(sup["mid_end"]) if "mid_end" in sup \
        else jnp.zeros(B, bool)

    def gather_pdf(score_t, pdfs):
        return jnp.take_along_axis(score_t, pdfs, axis=1)

    # frame 0: enter arcs out of the start state whose entry window
    # admits frame 0; a mid-utterance chunk (chunk_supervision) may
    # instead begin by entering ANY window-admissible arc, or inside
    # one (self emission — the chunk cut the phone in half)
    enter0 = jnp.abs(0 - bt_src) <= tol
    ok0 = jnp.where(mid_start[:, None], enter0, is_start & enter0)
    alpha0 = jnp.where(ok0, weight + gather_pdf(scores[:, 0], entry_pdf),
                       jnp.float32(NEG))                 # (B, A)
    stay0 = mid_start[:, None] & (0 > bt_src - tol) & (0 < bt_dst + tol)
    alpha0 = jnp.logaddexp(alpha0, jnp.where(
        stay0, gather_pdf(scores[:, 0], self_pdf), jnp.float32(NEG)))

    def step(carry, xs):
        alpha, corr = carry
        score_t, t = xs
        act = t < num_frames                              # (B,)
        # leave-arc → state mass: alpha of arcs whose dst boundary
        # window admits a transition at frame t
        ok_exit = jnp.abs(t - bt_dst) <= tol
        state_in = _batched_segment_logsumexp(
            jnp.where(ok_exit, alpha, jnp.float32(NEG)), dst, S)
        # enter arc a at frame t
        ok_entry = jnp.abs(t - bt_src) <= tol
        enter = jnp.where(
            ok_entry,
            jnp.take_along_axis(state_in, src, axis=1) + weight
            + gather_pdf(score_t, entry_pdf), jnp.float32(NEG))
        # stay inside arc a (self-loop pdf); staying past the window
        # end is pruned by requiring t within (bt_src−tol, bt_dst+tol)
        ok_stay = (t > bt_src - tol) & (t < bt_dst + tol)
        stay = jnp.where(ok_stay,
                         alpha + gather_pdf(score_t, self_pdf) + self_w,
                         jnp.float32(NEG))
        new = jnp.logaddexp(stay, enter)
        m = jnp.maximum(jnp.max(new, axis=1, keepdims=True),
                        jnp.float32(NEG))
        new = new - m
        new = jnp.where(act[:, None], new, alpha)
        corr = corr + jnp.where(act, m[:, 0], 0.0)
        return (new, corr), None

    (alphaT, corr), _ = jax.lax.scan(
        step, (alpha0, jnp.zeros(B)),
        (jnp.swapaxes(scores[:, 1:], 0, 1),
         jnp.arange(1, T, dtype=jnp.int32)))
    # finish: arcs whose dst is final and whose boundary admits T; a
    # mid-utterance chunk end instead accepts any arc alive at T−1
    fin_std = (jnp.take_along_axis(final, dst, axis=1)
               & (jnp.abs(num_frames[:, None] - bt_dst) <= tol))
    tend = num_frames[:, None] - 1
    alive = (tend >= bt_src - tol) & (tend < bt_dst + tol)
    fin_ok = jnp.where(mid_end[:, None], alive, fin_std)
    fw_eff = jnp.where(mid_end[:, None], 0.0, final_w)
    return corr + jax.scipy.special.logsumexp(
        jnp.where(fin_ok, alphaT + fw_eff, jnp.float32(NEG)), axis=1)
