"""Hard-corpus lattice-quality bench plumbing (pipelines/hard.py) +
oracle/depth lattice statistics (lattice/functions.py).

Parity: latbin/lattice-oracle.cc (min edit distance over lattice
paths), latbin/lattice-depth.cc (arc-frames per frame), and the
acceptance contract: nonzero 1-best WER with oracle WER
≤ 1-best WER.
"""

import numpy as np
import pytest

from kaldi_tpu.lattice.functions import lattice_depth, oracle_errors
from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice


def _lat(paths):
    """Linear-union lattice from [(words, tids_per_arc), ...]."""
    cl = CompactLattice()
    s0 = cl.add_state()
    cl.start = s0
    for words in paths:
        cur = s0
        for w in words:
            nxt = cl.add_state()
            cl.arcs[cur].append(CompactArc(w, 0.0, 0.0, (1, 1), nxt))
            cur = nxt
        cl.finals[cur] = (0.0, 0.0, ())
    return cl


def test_oracle_picks_best_path():
    cl = _lat([[1, 2, 3], [1, 4, 3], [5, 6]])
    assert oracle_errors(cl, [1, 4, 3]) == 0
    assert oracle_errors(cl, [1, 2, 3]) == 0
    assert oracle_errors(cl, [1, 9, 3]) == 1       # best: substitute
    assert oracle_errors(cl, [5, 6, 7]) == 1       # deletion
    assert oracle_errors(cl, [5]) == 1             # insertion
    assert oracle_errors(cl, [9, 9, 9, 9, 9]) == 5


def test_oracle_matches_cli_dp(rng):
    """Vectorized oracle == the CLI's per-cell DP on random lattices."""
    from kaldi_tpu.cli.tools_bank3 import _oracle_path
    for trial in range(20):
        n_paths = int(rng.integers(1, 4))
        paths = [list(rng.integers(1, 6, int(rng.integers(1, 6))))
                 for _ in range(n_paths)]
        cl = _lat(paths)
        ref = list(rng.integers(1, 6, int(rng.integers(1, 6))))
        assert oracle_errors(cl, ref) == _oracle_path(cl, ref)[0]


def test_oracle_epsilon_arcs():
    cl = CompactLattice()
    s0, s1, s2 = (cl.add_state() for _ in range(3))
    cl.start = s0
    cl.arcs[s0].append(CompactArc(0, 0.0, 0.0, (1,), s1))  # eps word
    cl.arcs[s1].append(CompactArc(7, 0.0, 0.0, (1,), s2))
    cl.finals[s2] = (0.0, 0.0, ())
    assert oracle_errors(cl, [7]) == 0
    assert oracle_errors(cl, []) == 1


def test_lattice_depth_linear_is_one():
    cl = _lat([[1, 2, 3]])
    num, den = lattice_depth(cl)
    assert num == den == 6
    cl2 = _lat([[1, 2], [3, 4]])       # two parallel 4-frame paths
    num, den = lattice_depth(cl2)
    assert (num, den) == (8, 4)


def test_confusable_entries_are_confusable():
    from kaldi_tpu.pipelines.hard import confusable_entries
    ents = confusable_entries(160, num_phones=12, variants=8, seed=3)
    assert len(ents) == 160
    # within a family (consecutive ids), variants differ from the base
    # in at most one position
    prons = [p for _, p in ents]
    for fam in range(0, 160, 8):
        base = prons[fam]
        for v in range(1, 8):
            diff = sum(a != b for a, b in zip(base, prons[fam + v]))
            assert len(base) == len(prons[fam + v]) and diff <= 1


@pytest.mark.slow
def test_hard_task_end_to_end_nonzero_wer():
    """Small-scale hard task: 1-best WER > 0, oracle ≤ 1-best, density
    ≥ 1 — the falsifiability contract of the hard bench."""
    from kaldi_tpu.pipelines.hard import (decode_eval, make_hard_task,
                                          score_lattices, synth_eval)
    task = make_hard_task(vocab=400, seed=7, num_phones=16,
                          corpus_sentences=2000)
    eval_set, lls = synth_eval(task, 24, noise=1.1, peak=3.5,
                               max_words=8)
    lats, stats = decode_eval(task, lls, batch=8, bucket=96,
                              arc_budget=2048)
    wer, oracle, density = score_lattices(task, eval_set, lats)
    assert wer.wer > 0.0
    assert oracle <= wer.wer
    assert density >= 1.0
    assert stats["audio_s"] > 0
