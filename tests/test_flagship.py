"""Flagship pipeline units: confusable-cluster lexicon, phrase-grammar
LM headroom, scaled best-path sweep, difference-LM pruned rescoring.

(The full system build — audio → GMM → chain → large-vocab decode →
4-gram rescore — runs as `python -m kaldi_tpu.pipelines.flagship`; its
RESULTS are JSON lines.  These tests pin the pieces cheap
enough for CI.)
"""

import numpy as np
import pytest

from kaldi_tpu.fst.arpa import estimate_arpa
from kaldi_tpu.pipelines.flagship import (flagship_lexicon,
                                          flagship_phones, phrase_texts)


def test_lexicon_confusable_within_clusters():
    entries, formants = flagship_lexicon(500, seed=3)
    assert len(entries) == 500
    phones, _ = flagship_phones()
    per = 3
    # variants differ from the family base in ≤1 position, and the
    # substitution stays within the phone's spectral cluster
    by_id = {int(w[1:]): pron for w, pron in entries}
    idx = {p: i for i, p in enumerate(phones)}
    i = 0
    checked = 0
    while i in by_id:
        base = by_id[i]
        j = i + 1
        while j in by_id and len(by_id[j]) == len(base) and j - i < 5:
            diff = [k for k in range(len(base))
                    if by_id[j][k] != base[k]]
            if len(diff) == 1:
                k = diff[0]
                assert idx[base[k]] // 3 == idx[by_id[j][k]] // 3
                checked += 1
            j += 1
        i = j
    assert checked > 100
    # cluster members are spectrally close (<10 % apart)
    for c in range(10):
        f = [formants[f"c{c:02d}p{m}"] for m in range(per)]
        for d in (0, 1):
            vals = [x[d] for x in f]
            assert (max(vals) - min(vals)) / min(vals) < 0.20


def test_phrase_grammar_gives_fourgram_headroom():
    """The 4-gram must beat the pruned trigram in perplexity on held-
    out phrase text — the headroom the rescoring stage claims."""
    words = [f"w{i:04d}" for i in range(300)]
    train = phrase_texts(words, 4000, n_phrases=300, seed=1,
                         phrase_seed=9)
    heldout = phrase_texts(words, 200, n_phrases=300, seed=2,
                           phrase_seed=9)
    arpa3 = estimate_arpa(train, order=3, prune_count=3, vocab=words)
    arpa4 = estimate_arpa(train, order=4, prune_count=1, vocab=words)

    def logprob(lm, sents):
        tot, n = 0.0, 0
        for s in sents:
            hist = ("<s>",)
            for w in s + ["</s>"]:
                tot += lm.score(hist, w)
                hist = hist + (w,)
                n += 1
        return tot / n
    lp3 = logprob(arpa3, heldout)
    lp4 = logprob(arpa4, heldout)
    assert lp4 > lp3 + 0.05, (lp3, lp4)


def _toy_clat():
    """Two-path lattice: path A cheap acoustically, path B cheap in
    graph cost — the sweep must pick different winners by scale."""
    from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice
    c = CompactLattice()
    s0, s1, s2, s3 = (c.add_state() for _ in range(4))
    c.start = s0
    c.arcs[s0].append(CompactArc(1, 4.0, 0.0, [1], s1))   # A: graph 4
    c.arcs[s1].append(CompactArc(2, 0.0, 0.0, [2], s3))
    c.arcs[s0].append(CompactArc(3, 1.0, 2.0, [3], s2))   # B: graph 1
    c.arcs[s2].append(CompactArc(4, 0.0, 0.0, [4], s3))
    c.finals[s3] = (0.0, 0.0, [])
    return c


def test_best_path_scaled_sweep():
    from kaldi_tpu.lattice.functions import best_path_scaled
    c = _toy_clat()
    # scale 1: B costs 3, A costs 4 → B
    w, cost = best_path_scaled(c, lm_scale=1.0)
    assert w == [3, 4] and cost == pytest.approx(3.0)
    # heavy LM scale: A (graph 4·s) loses even harder; light LM scale
    # 0.25: A costs 1.0, B costs 2.25 → A
    w, cost = best_path_scaled(c, lm_scale=0.25)
    assert w == [1, 2] and cost == pytest.approx(1.0)
    # lattice unmutated
    assert c.arcs[0][0].graph_cost == 4.0


def test_diff_pruned_matches_exact_rescore():
    """lmrescore_diff_pruned == lmrescore (exact two-pass) on a small
    lattice: same best path, same path costs."""
    from kaldi_tpu.fst.fst import SymbolTable
    from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice
    from kaldi_tpu.lattice.rescore import (lmrescore,
                                           lmrescore_diff_pruned)
    rng = np.random.default_rng(7)
    words = [f"v{i}" for i in range(8)]
    tab = SymbolTable()
    tab.add("<eps>", 0)
    for w in words:
        tab.add(w)
    texts = [[words[int(k)] for k in rng.integers(0, 8, 6)]
             for _ in range(400)]
    old = estimate_arpa(texts, order=2, prune_count=2, vocab=words)
    new = estimate_arpa(texts, order=3, prune_count=1, vocab=words)

    # random 3-step sausage lattice over the vocab
    c = CompactLattice()
    prev = [c.add_state()]
    c.start = prev[0]
    for t in range(3):
        nxt = c.add_state()
        for w in rng.integers(1, 9, 3):
            c.arcs[prev[0]].append(CompactArc(
                int(w), float(rng.random()), float(rng.random()),
                [1], nxt))
        prev = [nxt]
    c.finals[prev[0]] = (0.0, 0.0, [])

    exact = lmrescore(c, old, new, tab)
    fast = lmrescore_diff_pruned(c, old, new, tab, beam=100.0)

    def paths(cl):
        out = {}

        def go(s, ws, cost):
            if s in cl.finals:
                gc, ac, _ = cl.finals[s]
                k = tuple(ws)
                out[k] = min(out.get(k, np.inf), cost + gc + ac)
            for a in cl.arcs[s]:
                go(a.nextstate, ws + ([a.word] if a.word else []),
                   cost + a.graph_cost + a.acoustic_cost)
        go(cl.start, [], 0.0)
        return out
    pe, pf = paths(exact), paths(fast)
    assert set(pe) == set(pf)
    for k in pe:
        assert pf[k] == pytest.approx(pe[k], abs=1e-6)
