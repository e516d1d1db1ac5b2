"""Direct construction of large decode graphs (H ∘ det(L ∘ G)).

Parity target: the OUTPUT contract of egs/wsj/s5/utils/mkgraph.sh —
an HCLG over transition-ids with LM/lexicon/topology weights — at
realistic scale (tens of thousands of words, 10⁵–10⁶ states), which
the generic pipeline in fst/hclg.py (compose → determinize-star →
minimize over Python object FSTs) cannot reach in reasonable time.
The reference pays this cost once per graph in C++
(fstdeterminizestar on L∘G); here the determinized result is
constructed DIRECTLY, vectorized in numpy:

  * G's states are the ARPA histories (arpa-lm-compiler semantics:
    explicit word arcs for seen n-grams, #0/ε backoff arcs to the
    suffix history).
  * det(L∘G) is materialized per LM state as a phone PREFIX TREE over
    that state's explicit continuation words (exactly what
    determinization of L∘G produces: the per-state word fan-out
    becomes phone fan-out ≤ |phones|), with LM weights PUSHED toward
    the root (min-weight prefix pushing, the mkgraph push step) and
    word olabels emitted at the pronunciation end (where the
    determinized graph's disambiguation-symbol arcs become ε).
  * H expansion is arc-local: every phone arc's destination is
    phone-unique by construction (trie nodes), so HMM self-loops in
    the reorder=true convention attach directly to existing states —
    no AddSelfLoops state-splitting pass is needed.  Weight convention
    matches fst/hclg.py make_h_transducer/add_self_loops exactly, so
    small graphs built both ways are path-weight-identical (tested).
  * Optional inter-word silence mirrors make_lexicon_fst.pl: each
    word-end chooses no-sil (cost −log(1−p)) or sil (cost −log p,
    then the SIL phone) before the next word; double silence is
    impossible (the post-silence word-choice state has no SIL arc).

Output is a decode-ready CsrGraph (fst/csr.py) — numpy arrays that
upload straight to device memory, never a Python object FST.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu.core.logging import KaldiError, Timer, get_logger
from kaldi_tpu.fst.arpa import ArpaModel
from kaldi_tpu.fst.csr import OLSEQ_BASE, CsrGraph, expand_olabel
from kaldi_tpu.fst.fst import SymbolTable
from kaldi_tpu.am.topology import NO_PDF
from kaldi_tpu.am.transitions import TransitionModel

log = get_logger(__name__)


class OlInterner:
    """Interns olabel SEQUENCES so an arc can carry several word
    olabels after ε elimination (see csr.OLSEQ_BASE): a sequence of
    ≥2 words (or any word ≥ OLSEQ_BASE, which cannot occur for real
    vocabularies) is stored once and encoded as OLSEQ_BASE + index."""

    def __init__(self, seqs=None):
        self.seqs: List[tuple] = [tuple(s) for s in (seqs or [])]
        self._idx = {s: i for i, s in enumerate(self.seqs)}

    def encode(self, seq) -> int:
        seq = tuple(int(x) for x in seq)
        if not seq:
            return 0
        if len(seq) == 1 and seq[0] < OLSEQ_BASE:
            return seq[0]
        k = self._idx.get(seq)
        if k is None:
            k = len(self.seqs)
            self.seqs.append(seq)
            self._idx[seq] = k
        return OLSEQ_BASE + k

    def decode(self, ol: int) -> tuple:
        return expand_olabel(ol, self.seqs)

    def compose(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Elementwise concatenation of two encoded-olabel arrays
        (a's sequence first).  Vectorized over the (few) distinct
        nonzero pairs."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        out = np.where(a == 0, b, a)
        both = (a > 0) & (b > 0)
        if both.any():
            pairs = np.stack([a[both], b[both]], axis=1)
            up, inv = np.unique(pairs, axis=0, return_inverse=True)
            comp = np.asarray(
                [self.encode(self.decode(int(x)) + self.decode(int(y)))
                 for x, y in up], np.int64)
            out[both] = comp[inv]
        return out


@dataclasses.dataclass
class BigGraph:
    """A decode-ready graph plus its symbol tables."""
    csr: CsrGraph
    words: SymbolTable
    phones: SymbolTable
    num_lm_states: int


def make_symbol_tables(entries: Sequence[Tuple[str, Sequence[str]]],
                       sil_phone: str = "SIL"
                       ) -> Tuple[SymbolTable, SymbolTable]:
    """(words, phones) tables with the prepare_lang numbering
    conventions (<eps>=0, SIL=1; word table ends with #0/<s>/</s>)."""
    phones = SymbolTable()
    phones.add("<eps>", 0)
    phones.add(sil_phone, 1)
    for p in sorted({p for _, pron in entries for p in pron}):
        if p != sil_phone:
            phones.add(p)
    words = SymbolTable()
    words.add("<eps>", 0)
    for w in sorted({w for w, _ in entries}):
        words.add(w)
    words.add("#0")
    words.add("<s>")
    words.add("</s>")
    return words, phones


def _hmm_tables(tm: TransitionModel, phones: SymbolTable,
                transition_scale: float, self_loop_scale: float):
    """Per-phone linear-HMM expansion tables.

    Returns (E, fwd_tid, fwd_w, self_tid, self_w): E[p] = number of
    emitting states of phone p; fwd_tid[p, i] / fwd_w[p, i] = the
    transition-id and graph cost of the (reordered) arc that ENTERS
    hmm-state i; self_tid/self_w the state's self-loop.  Weights follow
    fst/hclg.py: w_fwd = −ts·(logp − log(1−p_self)) − sls·log(1−p_self),
    w_self = −sls·logp_self."""
    tree = tm.tree
    pids = [p for p in phones.ids() if p != 0]
    maxp = max(pids) + 1
    real = [p for p in pids if p in tm.topo.phones]
    Emax = 0
    for p in real:
        Emax = max(Emax, sum(
            1 for st in tm.topo.topology_for_phone(p)
            if st.forward_pdf_class != NO_PDF))
    E = np.zeros(maxp, np.int32)
    fwd_tid = np.zeros((maxp, Emax), np.int32)
    fwd_w = np.zeros((maxp, Emax), np.float32)
    self_tid = np.zeros((maxp, Emax), np.int32)
    self_w = np.zeros((maxp, Emax), np.float32)
    for p in real:
        entry = tm.topo.topology_for_phone(p)
        window = [0] * tree.context_width
        window[tree.central_position] = p
        i_emit = 0
        for hmm_state, st in enumerate(entry):
            if st.forward_pdf_class == NO_PDF:
                continue
            fwd_pdf = tree.compute(window, st.forward_pdf_class)
            slf_pdf = tree.compute(window, st.self_loop_pdf_class)
            ts = tm.tuple_to_transition_state(p, hmm_state, fwd_pdf, slf_pdf)
            stid = tm.self_loop_of(ts)
            log_1mp = tm.get_non_self_loop_log_prob(ts) if stid else 0.0
            fwd = [i for i, (ns, _) in enumerate(st.transitions)
                   if ns != hmm_state]
            if len(fwd) != 1:
                raise KaldiError(
                    "biglang supports linear (Bakis, no-skip) topologies; "
                    f"phone {p} state {hmm_state} has {len(fwd)} forward arcs")
            tid = tm.pair_to_transition_id(ts, fwd[0])
            fwd_tid[p, i_emit] = tid
            fwd_w[p, i_emit] = (-transition_scale
                                * (tm.get_log_prob(tid) - log_1mp)
                                - self_loop_scale * log_1mp)
            if stid:
                self_tid[p, i_emit] = stid
                self_w[p, i_emit] = -self_loop_scale * tm.get_log_prob(stid)
            E[p] += 1
            i_emit += 1
    return E, fwd_tid, fwd_w, self_tid, self_w


def _lm_and_trie(entries, arpa, words, phones, bos, eos, timer):
    """Steps 1-3 shared by the mono and context-dependent builds:
    LM states/arcs (arpa_to_fst semantics), the pronunciation trie,
    LM-arc x pronunciation expansion, active (h, node) pairs, and the
    pushed per-pair min weights."""
    order = arpa.order

    # ------------------------------------------------------------------
    # 1. LM states (histories) and explicit word arcs, arpa_to_fst style
    # ------------------------------------------------------------------
    state_of: Dict[Tuple[str, ...], int] = {}

    def canon(hist: Tuple[str, ...]) -> Tuple[str, ...]:
        hist = hist[-(order - 1):] if order > 1 else ()
        while hist and hist not in arpa.ngrams[len(hist) - 1]:
            hist = hist[1:]
        return hist

    def get_state(hist: Tuple[str, ...]) -> int:
        hist = canon(hist)
        if hist not in state_of:
            state_of[hist] = len(state_of)
        return state_of[hist]

    null_state = get_state(())
    start_lm = get_state((bos,))

    arc_h: List[int] = []          # src LM state
    arc_w: List[int] = []          # word symbol id
    arc_cost: List[float] = []     # −logprob
    arc_dst: List[int] = []        # dst LM state
    lm_final: Dict[int, float] = {}
    for n in range(1, order + 1):
        for ng, (logp, _bo) in arpa.ngrams[n - 1].items():
            word = ng[-1]
            hist = ng[:-1]
            if word == bos:
                continue
            if hist and hist != canon(hist):
                continue              # unreachable pruned history
            src = get_state(hist)
            if word == eos:
                prev = lm_final.get(src, np.inf)
                lm_final[src] = min(prev, -logp)
                continue
            if word not in words:
                continue
            arc_h.append(src)
            arc_w.append(words[word])
            arc_cost.append(-logp)
            arc_dst.append(get_state(ng))
    backoff_src: List[int] = []
    backoff_dst: List[int] = []
    backoff_w: List[float] = []
    for hist, sid in list(state_of.items()):
        if not hist:
            continue
        _, bo = arpa.ngrams[len(hist) - 1].get(hist, (0.0, 0.0))
        backoff_src.append(sid)
        backoff_dst.append(get_state(hist[1:]))
        backoff_w.append(-bo)
    H = len(state_of)
    log.info("biglang: %d LM states, %d word arcs, %d backoff arcs (%.1fs)",
             H, len(arc_h), len(backoff_src), timer.elapsed())

    # ------------------------------------------------------------------
    # 2. pronunciation trie over lexicon entries
    # ------------------------------------------------------------------
    children: List[Dict[int, int]] = [dict()]
    node_parent: List[int] = [-1]
    node_phone: List[int] = [0]
    entry_end: List[int] = []
    Lmax = max(len(pron) for _, pron in entries)
    entry_path = np.full((len(entries), Lmax), -1, np.int64)
    word_entries: Dict[int, List[int]] = {}
    for ei, (word, pron) in enumerate(entries):
        if word not in words:
            raise KaldiError(f"lexicon word {word!r} missing from table")
        node = 0
        for d, p in enumerate(pron):
            pid = phones[p]
            nxt = children[node].get(pid)
            if nxt is None:
                nxt = len(children)
                children[node][pid] = nxt
                children.append(dict())
                node_parent.append(node)
                node_phone.append(pid)
            node = nxt
            entry_path[ei, d] = node
        entry_end.append(node)
        word_entries.setdefault(words[word], []).append(ei)
    NN = len(children)
    node_parent = np.asarray(node_parent, np.int64)
    node_phone = np.asarray(node_phone, np.int32)
    entry_end = np.asarray(entry_end, np.int64)
    log.info("biglang: trie %d nodes over %d entries (%.1fs)",
             NN, len(entries), timer.elapsed())

    # ------------------------------------------------------------------
    # 3. expand LM word arcs over pronunciations; active (h, node) pairs
    # ------------------------------------------------------------------
    arc_h = np.asarray(arc_h, np.int64)
    arc_w = np.asarray(arc_w, np.int64)
    arc_cost = np.asarray(arc_cost, np.float32)
    arc_dst = np.asarray(arc_dst, np.int64)
    n_prons = np.asarray([len(word_entries.get(int(w), [])) for w in arc_w],
                         np.int64)
    if (n_prons == 0).any():
        miss = arc_w[n_prons == 0][:5]
        log.warning("biglang: %d LM words lack pronunciations (e.g. %s); "
                    "their arcs are dropped",
                    int((n_prons == 0).sum()),
                    [words.find(int(w)) for w in miss])
        keep = n_prons > 0
        arc_h, arc_w, arc_cost, arc_dst, n_prons = (
            arc_h[keep], arc_w[keep], arc_cost[keep], arc_dst[keep],
            n_prons[keep])
    # expanded arc list: one row per (LM arc, pronunciation)
    x_arc = np.repeat(np.arange(len(arc_h)), n_prons)
    x_entry = np.concatenate(
        [word_entries[int(w)] for w in arc_w]).astype(np.int64) \
        if len(arc_w) else np.zeros(0, np.int64)
    x_h = arc_h[x_arc]
    x_cost = arc_cost[x_arc]
    x_dst = arc_dst[x_arc]
    x_w = arc_w[x_arc]
    NX = len(x_arc)

    # active (h, node) pairs: every node on every expanded pronunciation
    pathm = entry_path[x_entry]                     # (NX, Lmax)
    valid = pathm >= 0
    pair_keys = (x_h[:, None] * NN + pathm)[valid]  # int64 packed
    pair_keys = np.unique(pair_keys)
    NP = len(pair_keys)

    def pair_id(h, node):
        return np.searchsorted(pair_keys, h * NN + node)

    # pushed weights: W_min(h, n) = min arc cost through (h, n)
    wmin = np.full(NP, np.float32(np.inf))
    flat_pairs = (x_h[:, None] * NN + pathm)[valid]
    flat_cost = np.broadcast_to(x_cost[:, None], pathm.shape)[valid]
    np.minimum.at(wmin, np.searchsorted(pair_keys, flat_pairs), flat_cost)

    pr_h = pair_keys // NN
    pr_node = pair_keys % NN
    pr_phone = node_phone[pr_node]
    pr_parent = node_parent[pr_node]
    log.info("biglang: %d expanded arcs, %d (lm-state, trie-node) pairs "
             "(%.1fs)", NX, NP, timer.elapsed())

    return (H, start_lm, lm_final,
            np.asarray(backoff_src, np.int64),
            np.asarray(backoff_dst, np.int64),
            np.asarray(backoff_w, np.float32),
            x_h, x_cost, x_dst, x_w, x_entry, x_arc,
            node_parent, node_phone, entry_end, NN,
            pair_keys, NP, pair_id, wmin, pr_h, pr_node, pr_phone,
            pr_parent)


def build_big_graph(entries: Sequence[Tuple[str, Sequence[str]]],
                    arpa: ArpaModel,
                    tm: TransitionModel,
                    words: SymbolTable,
                    phones: SymbolTable,
                    sil_phone: str = "SIL",
                    sil_prob: float = 0.5,
                    optional_sil: bool = True,
                    transition_scale: float = 1.0,
                    self_loop_scale: float = 0.1,
                    bos: str = "<s>", eos: str = "</s>") -> BigGraph:
    """Build the decode graph directly into CSR arrays.  See module
    docstring for the construction; ~seconds for 20k words / 10⁶
    states where the generic mkgraph pipeline would take hours.

    Context-independent (monophone) trees use the fast path below;
    triphone trees (context_width 3) dispatch to the context-dependent
    construction (_build_big_graph_cd), which emits phone windows with
    the same delayed semantics as fst/context.py."""
    if tm.tree.context_width != 1:
        return _build_big_graph_cd(
            entries, arpa, tm, words, phones, sil_phone, sil_prob,
            optional_sil, transition_scale, self_loop_scale, bos, eos)
    timer = Timer()
    core = _lm_and_trie(entries, arpa, words, phones, bos, eos, timer)
    (H, start_lm, lm_final, backoff_src, backoff_dst, backoff_w,
     x_h, x_cost, x_dst, x_w, x_entry, x_arc,
     node_parent, node_phone, entry_end, NN,
     pair_keys, NP, pair_id, wmin, pr_h, pr_node, pr_phone, pr_parent
     ) = core

    # ------------------------------------------------------------------
    # 4. phone-level states & arcs
    #    layout: 0 start_pre | roots | silst | sil_done | pairs
    # ------------------------------------------------------------------
    SIL = phones[sil_phone]
    root0 = 1
    silst0 = root0 + H
    sildone0 = silst0 + H
    pairs0 = sildone0 + H
    S_phone = pairs0 + NP

    no_sil_cost = -math.log(1.0 - sil_prob) if optional_sil else 0.0
    sil_cost = -math.log(sil_prob) if optional_sil else np.inf

    ph_src: List[np.ndarray] = []
    ph_dst: List[np.ndarray] = []
    ph_lab: List[np.ndarray] = []   # phone (0 = ε)
    ph_ol: List[np.ndarray] = []
    ph_wt: List[np.ndarray] = []

    def add(src, dst, lab, ol, wt):
        n = len(src)
        ph_src.append(np.asarray(src, np.int64))
        ph_dst.append(np.asarray(dst, np.int64))
        ph_lab.append(np.broadcast_to(np.asarray(lab, np.int32), (n,)))
        ph_ol.append(np.broadcast_to(np.asarray(ol, np.int32), (n,)))
        ph_wt.append(np.broadcast_to(np.asarray(wt, np.float32), (n,)))

    # trie arcs
    first = pr_parent == 0
    fsrc_root = root0 + pr_h[first]
    fdst = pairs0 + np.nonzero(first)[0]
    fw = wmin[first]
    add(fsrc_root, fdst, pr_phone[first], 0, fw)
    if optional_sil:
        add(sildone0 + pr_h[first], fdst, pr_phone[first], 0, fw)
    deep = ~first
    dsrc = pairs0 + pair_id(pr_h[deep], pr_parent[deep])
    ddst = pairs0 + np.nonzero(deep)[0]
    add(dsrc, ddst, pr_phone[deep],
        0, wmin[deep] - wmin[pair_id(pr_h[deep], pr_parent[deep])])

    # completion ε arcs (word olabel), with the sil / no-sil choice
    x_end_pair = pair_id(x_h, entry_end[x_entry])
    res_cost = x_cost - wmin[x_end_pair]
    add(pairs0 + x_end_pair, root0 + x_dst, 0, x_w, res_cost + no_sil_cost)
    if optional_sil:
        add(pairs0 + x_end_pair, silst0 + x_dst, 0, x_w, res_cost + sil_cost)
        # SIL phone arc, then word choice with no second silence
        hh = np.arange(H, dtype=np.int64)
        add(silst0 + hh, sildone0 + hh, SIL, 0, 0.0)

    # backoff ε arcs (on both word-choice variants)
    bsrc = np.asarray(backoff_src, np.int64)
    bdst = np.asarray(backoff_dst, np.int64)
    bw = np.asarray(backoff_w, np.float32)
    add(root0 + bsrc, root0 + bdst, 0, 0, bw)
    if optional_sil:
        add(sildone0 + bsrc, sildone0 + bdst, 0, 0, bw)

    # start: optional initial silence
    add([0], [root0 + start_lm], 0, 0, no_sil_cost)
    if optional_sil:
        add([0], [silst0 + start_lm], 0, 0, sil_cost)

    ph_src = np.concatenate(ph_src)
    ph_dst = np.concatenate(ph_dst)
    ph_lab = np.concatenate(ph_lab)
    ph_ol = np.concatenate(ph_ol)
    ph_wt = np.concatenate(ph_wt)

    # finals (explicit </s>; backoff reaches the rest through ε)
    final_phone = np.full(S_phone, np.float32(np.inf))
    for sid, c in lm_final.items():
        final_phone[root0 + sid] = c
        if optional_sil:
            final_phone[sildone0 + sid] = c

    # per-state phone identity (for self-loops): trie pairs + sil_done
    state_phone = np.zeros(S_phone, np.int32)
    state_phone[pairs0:pairs0 + NP] = pr_phone
    if optional_sil:
        state_phone[sildone0:sildone0 + H] = SIL
    log.info("biglang: %d phone-level states, %d arcs (%.1fs)",
             S_phone, len(ph_src), timer.elapsed())

    # ------------------------------------------------------------------
    # 5. H expansion: phone arcs → tid arcs (+ chain states for E>1),
    #    self-loops on phone-unique states (reorder=true)
    # ------------------------------------------------------------------
    E, fwd_tid, fwd_w, stid, sw = _hmm_tables(
        tm, phones, transition_scale, self_loop_scale)

    emit = ph_lab > 0
    nE = E[ph_lab[emit]]
    if (nE == 0).any():
        raise KaldiError("biglang: arc phone missing from topology")
    extra = nE - 1                              # intermediates per arc
    n_extra = int(extra.sum())
    inter0 = S_phone
    S_tot = S_phone + n_extra

    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_il: List[np.ndarray] = []
    e_ol: List[np.ndarray] = []
    e_wt: List[np.ndarray] = []

    em_src = ph_src[emit]
    em_dst = ph_dst[emit]
    em_ph = ph_lab[emit]
    em_ol = ph_ol[emit]
    em_wt = ph_wt[emit]
    if n_extra == 0:
        e_src.append(em_src)
        e_dst.append(em_dst)
        e_il.append(fwd_tid[em_ph, 0])
        e_ol.append(em_ol)
        e_wt.append(em_wt + fwd_w[em_ph, 0])
        inter_phone = np.zeros(0, np.int32)
        inter_state = np.zeros(0, np.int32)
    else:
        # chain states per arc: src → m_1 → … → m_{E−1} → dst
        offs = np.concatenate([[0], np.cumsum(extra)])
        inter_phone = np.repeat(em_ph, extra)
        inter_state = np.concatenate(
            [np.arange(k, dtype=np.int32) for k in extra]) \
            if n_extra else np.zeros(0, np.int32)
        Emax = fwd_tid.shape[1]
        for i in range(Emax):
            sel = nE > i
            n_sel = int(sel.sum())
            if n_sel == 0:
                break
            src_i = np.where(
                i == 0, em_src,
                inter0 + offs[:-1] + (i - 1))[sel]
            dst_i = np.where(
                i == nE - 1, em_dst,
                inter0 + offs[:-1] + i)[sel]
            e_src.append(src_i)
            e_dst.append(dst_i)
            e_il.append(fwd_tid[em_ph[sel], i])
            e_ol.append(np.where(i == 0, em_ol, 0)[sel])
            e_wt.append(np.where(i == 0, em_wt, 0.0)[sel]
                        + fwd_w[em_ph[sel], i])

    # self-loops: state s entered by the arc of (phone p, emit-state i)
    # gets that state's self-loop.  Trie/sil_done states are entered at
    # emit-state E[p]−1; intermediates at their chain position.
    sl_state = np.nonzero(state_phone > 0)[0]
    sl_phone = state_phone[sl_state]
    sl_pos = E[sl_phone] - 1
    if n_extra:
        sl_state = np.concatenate(
            [sl_state, inter0 + np.arange(n_extra)])
        sl_phone = np.concatenate([sl_phone, inter_phone])
        sl_pos = np.concatenate([sl_pos, inter_state])
    has_loop = stid[sl_phone, sl_pos] > 0
    e_src.append(sl_state[has_loop])
    e_dst.append(sl_state[has_loop])
    e_il.append(stid[sl_phone, sl_pos][has_loop])
    e_ol.append(np.zeros(int(has_loop.sum()), np.int32))
    e_wt.append(sw[sl_phone, sl_pos][has_loop])

    e_src = np.concatenate(e_src).astype(np.int64)
    e_dst = np.concatenate(e_dst).astype(np.int64)
    e_il = np.concatenate(e_il).astype(np.int32)
    e_ol = np.concatenate(e_ol).astype(np.int32)
    e_wt = np.concatenate(e_wt).astype(np.float32)

    n_src = ph_src[~emit]
    n_dst = ph_dst[~emit]
    n_ol = ph_ol[~emit]
    n_wt = ph_wt[~emit]

    final = np.full(S_tot, np.float32(np.inf))
    final[:S_phone] = final_phone
    csr = csr_from_arrays(S_tot, 0, e_src, e_dst, e_il, e_ol, e_wt,
                          n_src, n_dst, n_ol, n_wt, final)
    log.info("biglang: HCLG %d states, %d emitting + %d ε arcs, "
             "ε-depth %d (%.1fs total)", S_tot, csr.num_emitting_arcs,
             csr.num_eps_arcs, csr.eps_depth, timer.elapsed())
    return BigGraph(csr=csr, words=words, phones=phones, num_lm_states=H)


def _window_hmm_tables(tm: TransitionModel, wins: np.ndarray,
                       transition_scale: float, self_loop_scale: float):
    """Per-WINDOW linear-HMM expansion tables for context-dependent
    trees: ``wins`` is (W, 3) phone windows (center = the phone being
    expanded; 0 = padding at utterance edges).  Same weight convention
    as _hmm_tables / hclg.make_h_transducer (reorder=true)."""
    tree = tm.tree
    W = len(wins)
    ent_cache = {}
    Emax = 0
    for p in {int(c) for c in wins[:, 1]}:
        entry = tm.topo.topology_for_phone(p)
        n = sum(1 for st in entry if st.forward_pdf_class != NO_PDF)
        ent_cache[p] = entry
        Emax = max(Emax, n)
    E = np.zeros(W, np.int32)
    fwd_tid = np.zeros((W, Emax), np.int32)
    fwd_w = np.zeros((W, Emax), np.float32)
    self_tid = np.zeros((W, Emax), np.int32)
    self_w = np.zeros((W, Emax), np.float32)
    for wi in range(W):
        l, p, r = (int(v) for v in wins[wi])
        window = [l, p, r]
        i_emit = 0
        for hmm_state, st in enumerate(ent_cache[p]):
            if st.forward_pdf_class == NO_PDF:
                continue
            fwd_pdf = tree.compute(window, st.forward_pdf_class)
            slf_pdf = tree.compute(window, st.self_loop_pdf_class)
            ts = tm.tuple_to_transition_state(p, hmm_state, fwd_pdf,
                                              slf_pdf)
            stid = tm.self_loop_of(ts)
            log_1mp = tm.get_non_self_loop_log_prob(ts) if stid else 0.0
            fwd = [i for i, (ns, _) in enumerate(st.transitions)
                   if ns != hmm_state]
            if len(fwd) != 1:
                raise KaldiError(
                    "biglang supports linear (Bakis, no-skip) topologies; "
                    f"phone {p} state {hmm_state} has {len(fwd)} forward "
                    "arcs")
            tid = tm.pair_to_transition_id(ts, fwd[0])
            fwd_tid[wi, i_emit] = tid
            fwd_w[wi, i_emit] = (-transition_scale
                                 * (tm.get_log_prob(tid) - log_1mp)
                                 - self_loop_scale * log_1mp)
            if stid:
                self_tid[wi, i_emit] = stid
                self_w[wi, i_emit] = -self_loop_scale \
                    * tm.get_log_prob(stid)
            E[wi] += 1
            i_emit += 1
    return E, fwd_tid, fwd_w, self_tid, self_w


def _build_big_graph_cd(entries, arpa, tm, words, phones, sil_phone,
                        sil_prob, optional_sil, transition_scale,
                        self_loop_scale, bos, eos) -> BigGraph:
    """Direct construction with a CONTEXT-DEPENDENT (triphone) tree.

    Same output contract as the monophone fast path — a decode-ready
    HCLG over transition-ids, path-weight-equivalent to the generic
    mkgraph pipeline (compose_context + make_h_transducer + det + min)
    — with phone windows emitted under fst/context.py's delayed
    convention (delay = N−1−P = 1: consuming phone q completes the
    window of the phone seen one arc earlier).

    The trie makes word-internal windows DETERMINISTIC: a node at
    depth ≥ 2 knows its (parent, grandparent) phones, so only the
    junction states need context splitting:

      * word-choice (root) states split by the (l2, l1) phone pair
        arriving from the previous word / silence,
      * depth-1 trie nodes split by the left phone l1 alone,
      * the pre-silence state splits by (l2, l1) (consuming SIL emits
        the window (l2, l1, SIL); the post-silence word choice is just
        the root with context (l1, SIL)).

    A vectorized fixed point enumerates exactly the REACHABLE
    (lm-state, context) pairs — since an LM state's last word is fixed
    by its history, contexts per state ≈ its word's pronunciation
    endings, so the split stays near-linear in graph size instead of
    the naive |phones|² blowup.  Parity: src/fstext/context-fst.h
    window semantics + mkgraph.sh output, built directly at scale.
    """
    tree = tm.tree
    if (tree.context_width, tree.central_position) not in ((3, 1), (2, 1)):
        raise KaldiError(
            "biglang: context-dependent direct construction supports "
            "triphone (3,1) and left-biphone (2,1) trees; got "
            f"N={tree.context_width} P={tree.central_position}")
    # left-biphone trees ((2,1) — the chain/e2e build_tree.sh contract)
    # run through the same (3,1) machinery: tree.compute keys window
    # positions 0 (left) and 1 (center) and never queries position 2,
    # so the delayed-window construction is correct as-is, merely
    # emitting each HMM one arc later than a native delay-0 build —
    # the weighted (tids, words) transduction is identical.
    timer = Timer()
    (H, start_lm, lm_final, bo_src_a, bo_dst_a, bo_w_a,
     x_h, x_cost, x_dst, x_w, x_entry, _x_arc,
     node_parent, node_phone, entry_end, NN,
     pair_keys, NP, pair_id, wmin, pr_h, pr_node, pr_phone, pr_parent
     ) = _lm_and_trie(entries, arpa, words, phones, bos, eos, timer)

    SIL = phones[sil_phone]
    PH = max(phones.ids()) + 1
    C = PH * PH
    no_sil_cost = -math.log(1.0 - sil_prob) if optional_sil else 0.0
    sil_cost = -math.log(sil_prob) if optional_sil else np.inf

    has_bo = np.zeros(H, bool)
    bo_dst = np.zeros(H, np.int64)
    bo_w = np.zeros(H, np.float32)
    has_bo[bo_src_a] = True
    bo_dst[bo_src_a] = bo_dst_a
    bo_w[bo_src_a] = bo_w_a

    depth = np.zeros(NN, np.int32)
    for i in range(1, NN):
        depth[i] = depth[node_parent[i]] + 1
    pr_depth = depth[pr_node]

    d1_idx = np.nonzero(pr_depth == 1)[0]      # depth-1 pair ranks
    ND1P = len(d1_idx)
    d1_rank = np.full(NP, -1, np.int64)
    d1_rank[d1_idx] = np.arange(ND1P)
    dp_idx = np.nonzero(pr_depth >= 2)[0]
    NDP = len(dp_idx)
    dp_rank = np.full(NP, -1, np.int64)
    dp_rank[dp_idx] = np.arange(NDP)

    e_depth = depth[entry_end]
    e_l1 = node_phone[entry_end].astype(np.int64)       # last phone
    e_l2 = np.where(e_depth >= 2,
                    node_phone[node_parent[entry_end]], 0).astype(np.int64)

    xe_depth = e_depth[x_entry]
    deep_x = np.nonzero(xe_depth >= 2)[0]
    d1_x = np.nonzero(xe_depth == 1)[0]

    def _group(keys):
        """Sort row indices by LM state; return (sorted_rows, bounds)."""
        o = np.argsort(keys, kind="stable")
        return o, np.searchsorted(keys[o], np.arange(H + 1))

    o1, d1x_bounds = _group(x_h[d1_x])
    d1_xs = d1_x[o1]
    o2, dpx_bounds = _group(x_h[deep_x])
    dp_xs = deep_x[o2]

    def _join(h_arr, bounds, items):
        """All rows of ``items`` grouped under each h in h_arr.
        Returns (rep, picked): rep indexes h_arr."""
        lo = bounds[h_arr]
        cnt = bounds[h_arr + 1] - lo
        total = int(cnt.sum())
        rep = np.repeat(np.arange(len(h_arr)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        return rep, items[lo[rep] + within]

    # ------------------------------------------------------------------
    # fixed point: reachable (h, context) root keys + (h, hist) sil keys
    # ------------------------------------------------------------------
    R_set = np.asarray([start_lm * C], np.int64)        # context (0, 0)
    SS_set = (np.asarray([start_lm * C], np.int64) if optional_sil
              else np.zeros(0, np.int64))
    reach = np.zeros(H, bool)
    reach[start_lm] = True
    R_frontier = R_set.copy()
    SS_frontier = SS_set.copy()
    reach_frontier = np.asarray([start_lm], np.int64)
    for _round in range(100000):
        parts_R, parts_SS = [], []
        if len(SS_frontier):
            h = SS_frontier // C
            l1 = (SS_frontier % C) % PH
            parts_R.append(h * C + l1 * PH + SIL)
        if len(R_frontier):
            h = R_frontier // C
            cid = R_frontier % C
            m = has_bo[h]
            parts_R.append(bo_dst[h[m]] * C + cid[m])
            # depth-1-word completions fire per source context
            rep, j = _join(h, d1x_bounds, d1_xs)
            hist = (cid % PH)[rep] * PH + e_l1[x_entry[j]]
            parts_R.append(x_dst[j] * C + hist)
            if optional_sil:
                parts_SS.append(x_dst[j] * C + hist)
        if len(reach_frontier):
            # deep-word completions fire once per reached source state
            rep, j = _join(reach_frontier, dpx_bounds, dp_xs)
            hist = e_l2[x_entry[j]] * PH + e_l1[x_entry[j]]
            parts_R.append(x_dst[j] * C + hist)
            if optional_sil:
                parts_SS.append(x_dst[j] * C + hist)
        new_R = (np.unique(np.concatenate(parts_R)) if parts_R
                 else np.zeros(0, np.int64))
        new_SS = (np.unique(np.concatenate(parts_SS)) if parts_SS
                  else np.zeros(0, np.int64))
        R_frontier = new_R[~np.isin(new_R, R_set, assume_unique=True)]
        SS_frontier = new_SS[~np.isin(new_SS, SS_set, assume_unique=True)]
        if len(R_frontier) == 0 and len(SS_frontier) == 0:
            break
        R_set = np.union1d(R_set, R_frontier)
        SS_set = np.union1d(SS_set, SS_frontier)
        hs = np.unique(R_frontier // C)
        reach_frontier = hs[~reach[hs]]
        reach[reach_frontier] = True
    else:
        raise KaldiError("biglang cd: context fixed point did not "
                         "converge")

    NR = len(R_set)
    NS = len(SS_set)
    Rh = R_set // C
    Rcid = R_set % C
    Rl2 = Rcid // PH
    Rl1 = Rcid % PH

    # left-context sets L(h) = {c.l1 : (h, c) reachable}
    hl_keys = np.unique(Rh * PH + Rl1)
    hl_h = hl_keys // PH
    hl_l = hl_keys % PH
    hl_bounds = np.searchsorted(hl_h, np.arange(H + 1))

    # D1 states: depth-1 pairs × L(h); keys sorted by construction
    d1p_h = pr_h[d1_idx]
    repD, d1_l = _join(d1p_h, hl_bounds, hl_l)
    D1_keys = repD * PH + d1_l
    ND1 = len(D1_keys)

    roots0 = 1
    ss0 = roots0 + NR
    d10 = ss0 + NS
    dp0 = d10 + ND1
    F = dp0 + NDP
    S_phone = F + 1
    log.info("biglang cd: %d contexts over %d LM states (%d root, %d sil,"
             " %d depth-1, %d deep states) (%.1fs)",
             len(hl_keys), H, NR, NS, ND1, NDP, timer.elapsed())

    def _lookup(table, keys, what):
        # clip before the equality check: a key past the table end
        # must raise the actionable KaldiError, not IndexError
        idx = np.searchsorted(table, keys)
        safe = np.minimum(idx, max(len(table) - 1, 0))
        if len(np.atleast_1d(idx)) and not (
                (idx == safe) & (table[safe] == keys)).all():
            raise KaldiError(f"biglang cd: missing {what} key")
        return idx

    def rstate(keys):
        return roots0 + _lookup(R_set, keys, "root context")

    def sstate(keys):
        return ss0 + _lookup(SS_set, keys, "sil context")

    def d1state(rank, l):
        return d10 + _lookup(D1_keys, rank * PH + l, "depth-1 split")

    a_src: List[np.ndarray] = []
    a_dst: List[np.ndarray] = []
    a_wl: List[np.ndarray] = []
    a_wc: List[np.ndarray] = []    # window center; 0 = no HMM (ε)
    a_wr: List[np.ndarray] = []
    a_ol: List[np.ndarray] = []
    a_wt: List[np.ndarray] = []

    def addw(src, dst, wl, wc, wr, ol, wt):
        src = np.atleast_1d(np.asarray(src, np.int64))
        n = len(src)
        a_src.append(src)
        a_dst.append(np.broadcast_to(np.asarray(dst, np.int64), (n,)))
        a_wl.append(np.broadcast_to(np.asarray(wl, np.int32), (n,)))
        a_wc.append(np.broadcast_to(np.asarray(wc, np.int32), (n,)))
        a_wr.append(np.broadcast_to(np.asarray(wr, np.int32), (n,)))
        a_ol.append(np.broadcast_to(np.asarray(ol, np.int32), (n,)))
        a_wt.append(np.broadcast_to(np.asarray(wt, np.float32), (n,)))

    # 1. root fan-out: R(h, c) --q1 [window (l2, l1, q1)]--> D1(n1, l1)
    o3, d1p_bounds = _group(d1p_h)
    repR, rankp = _join(Rh, d1p_bounds, o3)
    pairi = d1_idx[rankp]
    addw(roots0 + repR, d1state(rankp, Rl1[repR]),
         Rl2[repR], Rl1[repR], pr_phone[pairi], 0, wmin[pairi])

    # 2. depth-1 → depth-2: window (l, q1, q2), per l ∈ L(h)
    j2 = np.nonzero(pr_depth == 2)[0]
    if len(j2):
        pp2 = pair_id(pr_h[j2], pr_parent[j2])
        rank2 = d1_rank[pp2]
        rep2, l2v = _join(pr_h[j2], hl_bounds, hl_l)
        addw(d1state(rank2[rep2], l2v), dp0 + dp_rank[j2[rep2]],
             l2v, pr_phone[pp2][rep2], pr_phone[j2[rep2]], 0,
             (wmin[j2] - wmin[pp2])[rep2])

    # 3. deep trie arcs: window fully determined by the trie
    j3 = np.nonzero(pr_depth >= 3)[0]
    if len(j3):
        pp3 = pair_id(pr_h[j3], pr_parent[j3])
        gp = node_phone[node_parent[pr_parent[j3]]]
        addw(dp0 + dp_rank[pp3], dp0 + dp_rank[j3],
             gp, pr_phone[pp3], pr_phone[j3], 0, wmin[j3] - wmin[pp3])

    # 4. deep-word completions (ε, word olabel, residual LM weight)
    sel4 = deep_x[reach[x_h[deep_x]]]
    if len(sel4):
        ep4 = pair_id(x_h[sel4], entry_end[x_entry[sel4]])
        res4 = x_cost[sel4] - wmin[ep4]
        hist4 = e_l2[x_entry[sel4]] * PH + e_l1[x_entry[sel4]]
        addw(dp0 + dp_rank[ep4], rstate(x_dst[sel4] * C + hist4),
             0, 0, 0, x_w[sel4], res4 + no_sil_cost)
        if optional_sil:
            addw(dp0 + dp_rank[ep4], sstate(x_dst[sel4] * C + hist4),
                 0, 0, 0, x_w[sel4], res4 + sil_cost)

    # 5. depth-1-word completions, per left context l ∈ L(h)
    sel5 = d1_x[reach[x_h[d1_x]]]
    if len(sel5):
        rep5, l5 = _join(x_h[sel5], hl_bounds, hl_l)
        ep5 = d1_rank[pair_id(x_h[sel5], entry_end[x_entry[sel5]])]
        res5 = x_cost[sel5] - wmin[d1_idx[ep5]]
        hist5 = l5 * PH + e_l1[x_entry[sel5]][rep5]
        addw(d1state(ep5[rep5], l5),
             rstate(x_dst[sel5][rep5] * C + hist5),
             0, 0, 0, x_w[sel5][rep5], res5[rep5] + no_sil_cost)
        if optional_sil:
            addw(d1state(ep5[rep5], l5),
                 sstate(x_dst[sel5][rep5] * C + hist5),
                 0, 0, 0, x_w[sel5][rep5], res5[rep5] + sil_cost)

    # 6. silence: SS(h, c) --SIL [window (l2, l1, SIL)]--> R(h, (l1, SIL))
    if NS:
        sh = SS_set // C
        scid = SS_set % C
        addw(ss0 + np.arange(NS), rstate(sh * C + (scid % PH) * PH + SIL),
             scid // PH, scid % PH, SIL, 0, 0.0)

    # 7. backoff ε arcs preserve context
    m7 = np.nonzero(has_bo[Rh])[0]
    if len(m7):
        addw(roots0 + m7, rstate(bo_dst[Rh[m7]] * C + Rcid[m7]),
             0, 0, 0, 0, bo_w[Rh[m7]])

    # 8. start: optional initial silence, context (0, 0)
    addw([0], rstate(np.asarray([start_lm * C], np.int64)),
         0, 0, 0, 0, no_sil_cost)
    if optional_sil:
        addw([0], sstate(np.asarray([start_lm * C], np.int64)),
             0, 0, 0, 0, sil_cost)

    # 9. finals: flush the pending phone with empty right context
    final_phone = np.full(S_phone, np.float32(np.inf))
    fcost_h = np.full(H, np.inf)
    for sid, c in lm_final.items():
        fcost_h[sid] = c
    fin = np.isfinite(fcost_h[Rh])
    fin0 = np.nonzero(fin & (Rl1 == 0))[0]
    final_phone[roots0 + fin0] = fcost_h[Rh[fin0]]
    finE = np.nonzero(fin & (Rl1 > 0))[0]
    if len(finE):
        addw(roots0 + finE, F, Rl2[finE], Rl1[finE], 0, 0,
             fcost_h[Rh[finE]].astype(np.float32))
        final_phone[F] = 0.0

    a_src = np.concatenate(a_src)
    a_dst = np.concatenate(a_dst)
    a_wl = np.concatenate(a_wl)
    a_wc = np.concatenate(a_wc)
    a_wr = np.concatenate(a_wr)
    a_ol = np.concatenate(a_ol)
    a_wt = np.concatenate(a_wt)
    log.info("biglang cd: %d phone-level states, %d arcs (%.1fs)",
             S_phone, len(a_src), timer.elapsed())

    # ------------------------------------------------------------------
    # H expansion per WINDOW; full per-arc chains (the window is an arc
    # property here, so shared destinations can't carry the self-loop),
    # except deep (depth ≥ 3) trie destinations, whose single in-arc
    # has a trie-determined window — those merge mono-style.
    # ------------------------------------------------------------------
    emit = a_wc > 0
    wkey = (a_wl[emit].astype(np.int64) * PH + a_wc[emit]) * PH \
        + a_wr[emit]
    uw, em_w = np.unique(wkey, return_inverse=True)
    wins = np.stack([uw // (PH * PH), (uw // PH) % PH, uw % PH],
                    1).astype(np.int32)
    E, fwd_tid, fwd_w, stid, sw = _window_hmm_tables(
        tm, wins, transition_scale, self_loop_scale)
    log.info("biglang cd: %d distinct windows (%.1fs)", len(uw),
             timer.elapsed())

    em_src = a_src[emit]
    em_dst = a_dst[emit]
    em_ol = a_ol[emit]
    em_wt = a_wt[emit]
    nE = E[em_w]
    if (nE == 0).any():
        raise KaldiError("biglang cd: window center missing from "
                         "topology")
    in_dp = (em_dst >= dp0) & (em_dst < dp0 + NDP)
    merge = np.zeros(len(em_src), bool)
    if NDP:
        k = np.where(in_dp, em_dst - dp0, 0)
        merge = in_dp & (pr_depth[dp_idx[k]] >= 3)

    n_int = nE - merge.astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(n_int)]).astype(np.int64)
    inter0 = S_phone
    n_inter = int(offs[-1])
    Emax = fwd_tid.shape[1]

    e_src: List[np.ndarray] = []
    e_dst: List[np.ndarray] = []
    e_il: List[np.ndarray] = []
    e_ol: List[np.ndarray] = []
    e_wt: List[np.ndarray] = []
    for i in range(Emax):
        sel = nE > i
        if not sel.any():
            break
        src_i = np.where(i == 0, em_src, inter0 + offs[:-1] + i - 1)[sel]
        last_merge = merge & (nE == i + 1)
        dst_i = np.where(last_merge, em_dst, inter0 + offs[:-1] + i)[sel]
        e_src.append(src_i)
        e_dst.append(dst_i)
        e_il.append(fwd_tid[em_w[sel], i])
        e_ol.append(np.where(i == 0, em_ol, 0)[sel])
        e_wt.append(np.where(i == 0, em_wt, 0.0)[sel]
                    + fwd_w[em_w[sel], i])

    # self-loops: per-arc chain states + merged deep destinations
    total_int = int(n_int.sum())
    sl_state = inter0 + np.repeat(offs[:-1], n_int) \
        + (np.arange(total_int)
           - np.repeat(np.cumsum(n_int) - n_int, n_int))
    sl_wid = np.repeat(em_w, n_int)
    sl_pos = (np.arange(total_int)
              - np.repeat(np.cumsum(n_int) - n_int, n_int))
    if merge.any():
        sl_state = np.concatenate([sl_state, em_dst[merge]])
        sl_wid = np.concatenate([sl_wid, em_w[merge]])
        sl_pos = np.concatenate([sl_pos, nE[merge] - 1])
    keep = stid[sl_wid, sl_pos] > 0
    e_src.append(sl_state[keep])
    e_dst.append(sl_state[keep])
    e_il.append(stid[sl_wid, sl_pos][keep])
    e_ol.append(np.zeros(int(keep.sum()), np.int32))
    e_wt.append(sw[sl_wid, sl_pos][keep])

    e_src = np.concatenate(e_src).astype(np.int64)
    e_dst = np.concatenate(e_dst).astype(np.int64)
    e_il = np.concatenate(e_il).astype(np.int32)
    e_ol = np.concatenate(e_ol).astype(np.int32)
    e_wt = np.concatenate(e_wt).astype(np.float32)

    # ε arcs: non-emitting phone-level arcs + unmerged chain ends
    um = np.nonzero(~merge)[0]
    n_src = np.concatenate([a_src[~emit],
                            inter0 + offs[:-1][um] + nE[um] - 1])
    n_dst = np.concatenate([a_dst[~emit], em_dst[um]])
    n_ol = np.concatenate([a_ol[~emit],
                           np.zeros(len(um), np.int32)])
    n_wt = np.concatenate([a_wt[~emit],
                           np.zeros(len(um), np.float32)])

    S_tot = S_phone + n_inter
    final = np.full(S_tot, np.float32(np.inf))
    final[:S_phone] = final_phone
    csr = csr_from_arrays(S_tot, 0, e_src, e_dst, e_il, e_ol, e_wt,
                          n_src, n_dst, n_ol, n_wt, final)
    log.info("biglang cd: HCLG %d states, %d emitting + %d ε arcs, "
             "ε-depth %d (%.1fs total)", S_tot, csr.num_emitting_arcs,
             csr.num_eps_arcs, csr.eps_depth, timer.elapsed())
    return BigGraph(csr=csr, words=words, phones=phones, num_lm_states=H)


def csr_from_arrays(S: int, start: int,
                    e_src, e_dst, e_il, e_ol, e_wt,
                    n_src, n_dst, n_ol, n_wt,
                    final: np.ndarray) -> CsrGraph:
    """Assemble a CsrGraph from flat arc arrays (vectorized — the
    object-FST path goes through fst/csr.py pack_fst instead)."""
    eo = np.argsort(e_src, kind="stable")
    no = np.argsort(n_src, kind="stable")
    e_off = np.zeros(S + 1, np.int64)
    np.add.at(e_off, e_src + 1, 1)
    e_off = np.cumsum(e_off)
    n_off = np.zeros(S + 1, np.int64)
    np.add.at(n_off, n_src + 1, 1)
    n_off = np.cumsum(n_off)

    n_ns = n_dst[no].astype(np.int32)
    depth = _eps_depth_vec(S, n_src[no].astype(np.int64),
                           n_ns.astype(np.int64))
    e_deg = np.diff(e_off)
    n_deg = np.diff(n_off)
    return CsrGraph(
        num_states=S,
        start=start,
        e_offsets=e_off.astype(np.int32),
        e_ilabel=e_il[eo].astype(np.int32),
        e_olabel=e_ol[eo].astype(np.int32),
        e_weight=e_wt[eo].astype(np.float32),
        e_nextstate=e_dst[eo].astype(np.int32),
        n_offsets=n_off.astype(np.int32),
        n_olabel=n_ol[no].astype(np.int32),
        n_weight=n_wt[no].astype(np.float32),
        n_nextstate=n_ns,
        final_costs=final.astype(np.float32),
        max_emit_degree=int(e_deg.max(initial=0)),
        max_eps_degree=int(n_deg.max(initial=0)),
        eps_depth=depth,
    )


def eps_close(g: CsrGraph) -> CsrGraph:
    """Transitively close the ε arc set so the ε-DAG depth becomes 1 —
    the decoder then needs ONE ε sweep per frame instead of depth-many
    (the dominant per-frame cost at depth 3).  Each ε path in these
    graphs carries at most one olabel (word-completion arcs originate at
    trie leaves, which are never ε-destinations; backoff chains carry
    none), so every closed path is representable as a single arc.
    Viterbi and lattice semantics are preserved exactly: with one sweep,
    each original ε path corresponds to exactly one closure arc."""
    src = []
    dst = []
    w = []
    ol = []
    for s in range(g.num_states):
        lo, hi = g.n_offsets[s], g.n_offsets[s + 1]
        if hi > lo:
            src.append(np.full(hi - lo, s, np.int64))
            dst.append(g.n_nextstate[lo:hi].astype(np.int64))
            w.append(g.n_weight[lo:hi].astype(np.float64))
            ol.append(g.n_olabel[lo:hi].astype(np.int64))
    src = np.concatenate(src) if src else np.zeros(0, np.int64)
    dst = np.concatenate(dst) if dst else np.zeros(0, np.int64)
    w = np.concatenate(w) if w else np.zeros(0)
    ol = np.concatenate(ol) if ol else np.zeros(0, np.int64)

    # one-step arcs indexed by source for the join
    order_idx = np.argsort(src, kind="stable")
    s_sorted = src[order_idx]
    bounds = np.searchsorted(s_sorted, np.arange(g.num_states + 1))
    all_src, all_dst, all_w, all_ol = [src], [dst], [w], [ol]
    cur_src, cur_dst, cur_w, cur_ol = src, dst, w, ol
    for _ in range(64):
        # join current paths with one more ε step
        lo = bounds[cur_dst]
        hi = bounds[cur_dst + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            break
        rep = np.repeat(np.arange(len(cur_src)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        step = order_idx[lo[rep] + within]
        new_src = cur_src[rep]
        new_dst = dst[step]
        new_w = cur_w[rep] + w[step]
        if (ol[step][cur_ol[rep] > 0] > 0).any():
            raise KaldiError("eps_close: two olabels on one ε path")
        new_ol = np.maximum(cur_ol[rep], ol[step])
        all_src.append(new_src)
        all_dst.append(new_dst)
        all_w.append(new_w)
        all_ol.append(new_ol)
        cur_src, cur_dst, cur_w, cur_ol = new_src, new_dst, new_w, new_ol
    else:
        raise KaldiError("eps_close: ε-cycle")

    n_src = np.concatenate(all_src)
    n_dst = np.concatenate(all_dst)
    n_w = np.concatenate(all_w).astype(np.float32)
    n_ol = np.concatenate(all_ol).astype(np.int32)
    # dedupe (src, dst, olabel) keeping min weight (tropical)
    key = (n_src * g.num_states + n_dst) * (n_ol.max() + 1 if len(n_ol)
                                            else 1) + n_ol
    uk, inv = np.unique(key, return_inverse=True)
    wmin = np.full(len(uk), np.float32(np.inf))
    np.minimum.at(wmin, inv, n_w)
    first = np.zeros(len(uk), np.int64)
    seen = np.full(len(uk), -1, np.int64)
    np.maximum.at(seen, inv, np.arange(len(inv)))
    first = seen
    n_src, n_dst, n_ol, n_w = (n_src[first], n_dst[first], n_ol[first],
                               wmin)

    e_src = np.repeat(np.arange(g.num_states, dtype=np.int64),
                      np.diff(g.e_offsets))
    out = csr_from_arrays(
        g.num_states, g.start,
        e_src, g.e_nextstate.astype(np.int64), g.e_ilabel, g.e_olabel,
        g.e_weight,
        n_src, n_dst, n_ol, n_w, g.final_costs)
    out.eps_sweeps = 1 if out.num_eps_arcs else 0
    log.info("eps_close: %d → %d ε arcs, sweeps %d → %d",
             g.num_eps_arcs, out.num_eps_arcs, g.num_sweeps,
             out.num_sweeps)
    return out


def eps_closure_arcs(g: CsrGraph, interner: Optional[OlInterner] = None):
    """All nonempty ε paths compressed to single arcs:
    (src, dst, weight, olabel) arrays.  Paths crossing several word
    olabels (1-phone words in triphone graphs, determinized-CLG olabel
    placement) are encoded as olabel SEQUENCES via the interner."""
    if interner is None:
        interner = OlInterner(g.olabel_seqs)
    src = np.repeat(np.arange(g.num_states, dtype=np.int64),
                    np.diff(g.n_offsets))
    dst = g.n_nextstate.astype(np.int64)
    w = g.n_weight.astype(np.float64)
    ol = g.n_olabel.astype(np.int64)
    order_idx = np.argsort(src, kind="stable")
    s_sorted = src[order_idx]
    bounds = np.searchsorted(s_sorted, np.arange(g.num_states + 1))
    all_parts = [(src, dst, w, ol)]
    cur = (src, dst, w, ol)
    for _ in range(64):
        c_src, c_dst, c_w, c_ol = cur
        lo = bounds[c_dst]
        hi = bounds[c_dst + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            break
        rep = np.repeat(np.arange(len(c_src)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        step = order_idx[lo[rep] + within]
        cur = (c_src[rep], dst[step], c_w[rep] + w[step],
               interner.compose(c_ol[rep], ol[step]))
        all_parts.append(cur)
    else:
        raise KaldiError("eps closure: ε-cycle")
    a_src = np.concatenate([p[0] for p in all_parts])
    a_dst = np.concatenate([p[1] for p in all_parts])
    a_w = np.concatenate([p[2] for p in all_parts])
    a_ol = np.concatenate([p[3] for p in all_parts])
    # dedupe (src, dst, olabel-seq) keeping min weight; densify the
    # olabel axis first (encoded labels are >= 2^24 — a direct product
    # key would overflow int64 at realistic state counts)
    uol, ol_idx = (np.unique(a_ol, return_inverse=True)
                   if len(a_ol) else (np.zeros(1, np.int64),
                                      np.zeros(0, np.int64)))
    key = (a_src * g.num_states + a_dst) * len(uol) + ol_idx
    uk, inv = np.unique(key, return_inverse=True)
    wmin = np.full(len(uk), np.inf)
    np.minimum.at(wmin, inv, a_w)
    rep_idx = np.full(len(uk), -1, np.int64)
    np.maximum.at(rep_idx, inv, np.arange(len(inv)))
    return (a_src[rep_idx], a_dst[rep_idx], wmin.astype(np.float32),
            a_ol[rep_idx].astype(np.int64))


def eps_precompose(g: CsrGraph) -> CsrGraph:
    """Eliminate ε arcs entirely by composing each emitting arc with
    the ε-closure of its destination, and folding ε-to-final paths
    into the final costs.  The decoder then runs ONE sweep per frame
    (no ε sweeps at all) — every sweep pays sorts + an arc gather,
    so ε sweeps were the biggest per-frame cost.

    Start-state ε paths become extra INITIAL tokens, recorded in
    CsrGraph.init_states/init_costs (the decoder's host-computed
    initial closure); a word olabel on a start-closure path rides in
    CsrGraph.init_olabels.  Paths carrying several word olabels
    (1-phone words in triphone graphs, determinized-CLG placement)
    become sequence-encoded olabels (csr.OLSEQ_BASE + index into
    CsrGraph.olabel_seqs) which host-side lattice/best-path assembly
    expands back into word sequences."""
    if g.num_eps_arcs == 0:
        out = g
    else:
        interner = OlInterner(g.olabel_seqs)
        c_src, c_dst, c_w, c_ol = eps_closure_arcs(g, interner)
        order_idx = np.argsort(c_src, kind="stable")
        cs = c_src[order_idx]
        bounds = np.searchsorted(cs, np.arange(g.num_states + 1))

        e_src = np.repeat(np.arange(g.num_states, dtype=np.int64),
                          np.diff(g.e_offsets))
        e_dst = g.e_nextstate.astype(np.int64)
        lo = bounds[e_dst]
        hi = bounds[e_dst + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        rep = np.repeat(np.arange(len(e_src)), cnt)
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        step = order_idx[lo[rep] + within]
        new_src = np.concatenate([e_src, e_src[rep]])
        new_dst = np.concatenate([e_dst, c_dst[step]])
        new_il = np.concatenate([g.e_ilabel, g.e_ilabel[rep]])
        new_ol = np.concatenate(
            [g.e_olabel.astype(np.int64),
             interner.compose(g.e_olabel[rep], c_ol[step])])
        new_w = np.concatenate(
            [g.e_weight, g.e_weight[rep] + c_w[step]])

        # fold ε-to-final paths into final costs — but only OLABEL-FREE
        # ones: a word-carrying ε to a final state is already covered by
        # the composed (emit+ε) arc landing past it, and folding it here
        # would create an equal-cost duplicate path WITHOUT the word
        final = g.final_costs.copy()
        nol = c_ol == 0
        f = final[c_dst[nol]] + c_w[nol]
        np.minimum.at(final, c_src[nol], f.astype(np.float32))

        z = np.zeros(0, np.int64)
        out = csr_from_arrays(
            g.num_states, g.start, new_src, new_dst,
            new_il.astype(np.int32), new_ol.astype(np.int32),
            new_w.astype(np.float32),
            z, z, np.zeros(0, np.int32), np.zeros(0, np.float32), final)
        # initial tokens = start + its ε closure (word olabels on a
        # start path ride per-token; a word-carrying ε path to a FINAL
        # state must also keep a distinct token — the olabel-free final
        # fold above deliberately skipped it)
        sel = c_src == g.start
        out.init_states = np.concatenate(
            [[g.start], c_dst[sel]]).astype(np.int32)
        out.init_costs = np.concatenate(
            [[0.0], c_w[sel]]).astype(np.float32)
        out.init_olabels = np.concatenate(
            [[0], c_ol[sel]]).astype(np.int64)
        out.olabel_seqs = interner.seqs
        n_enc = int((new_ol >= OLSEQ_BASE).sum())
        log.info("eps_precompose: %d ε arcs folded; emitting %d → %d "
                 "arcs, %d initial tokens, %d seq-encoded olabels",
                 g.num_eps_arcs, g.num_emitting_arcs,
                 out.num_emitting_arcs, len(out.init_states), n_enc)
    return out


def _eps_depth_vec(S: int, src: np.ndarray, dst: np.ndarray,
                   max_depth: int = 64) -> int:
    """Longest ε-path length, by vectorized relaxation (numpy
    maximum.at per round; rounds = depth+1 ≤ max_depth or raise)."""
    if len(src) == 0:
        return 0
    depth = np.zeros(S, np.int64)
    for _ in range(max_depth + 1):
        new = depth.copy()
        np.maximum.at(new, dst, depth[src] + 1)
        if (new == depth).all():
            return int(depth.max())
        depth = new
    raise KaldiError("ε-depth exceeds bound (cycle?)")
