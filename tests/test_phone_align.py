"""phone_align unit tests: cross-arc phone buffering + boost guard.

Parity: src/lat/phone-align-lattice.cc (LatticePhoneAligner buffers
partial phones across input arcs) and src/lat/lattice-functions.cc
LatticeBoost (requires alignment length == lattice frame count).
"""

import numpy as np
import pytest

from kaldi_tpu.core.logging import KaldiError
from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice
from kaldi_tpu.lattice.phone_align import (boost_lattice_ali,
                                           phone_align_lattice)


@pytest.fixture(scope="module")
def tm():
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.transitions import TransitionModel
    from kaldi_tpu.am.tree import MonophoneContextDependency
    topo = HmmTopology.three_state([1, 2, 3])
    tree = MonophoneContextDependency([1, 2, 3], topo)
    return TransitionModel(topo, tree)


def _phone_tids(tm, phone, frames):
    first = next(t for t in range(1, tm.num_transition_ids + 1)
                 if tm.transition_id_to_phone(t) == phone
                 and tm.transition_id_to_hmm_state(t) == 0
                 and not tm.is_self_loop(t))
    loop = next(t for t in range(1, tm.num_transition_ids + 1)
                if tm.transition_id_to_phone(t) == phone
                and tm.transition_id_to_hmm_state(t) == 0
                and tm.is_self_loop(t))
    return [first] + [loop] * (frames - 1)


def _tid_paths(cl):
    out = []
    stack = [(cl.start, (), 0.0)]
    while stack:
        s, tids, cost = stack.pop()
        if s in cl.finals:
            gc, ac, ftids = cl.finals[s]
            out.append((tids + tuple(ftids), round(cost + gc + ac, 6)))
        for a in cl.arcs[s]:
            stack.append((a.nextstate, tids + tuple(a.tids),
                          cost + a.graph_cost + a.acoustic_cost))
    return sorted(out)


def _phone_arcs(out, tm):
    """All (olabel, phone-set-of-tids) for non-epsilon arcs."""
    res = []
    for s in range(out.num_states):
        for a in out.arcs[s]:
            if a.tids:
                res.append((a.word,
                            [tm.transition_id_to_phone(t)
                             for t in a.tids]))
    return res


def test_phone_spanning_two_arcs_emits_one_arc(tm):
    """A phone split across an input-arc boundary must come out as ONE
    arc, not two partial arcs (a past bug)."""
    tids = _phone_tids(tm, 1, 6)
    clat = CompactLattice()
    s0, s1, s2 = (clat.add_state() for _ in range(3))
    clat.start = s0
    # phone 1's six tids split 2 / 4 across two arcs
    clat.arcs[s0].append(CompactArc(7, 1.0, 2.0, tuple(tids[:2]), s1))
    clat.arcs[s1].append(CompactArc(0, 0.5, 1.5, tuple(tids[2:]), s2))
    clat.finals[s2] = (0.25, 0.0, ())

    out = phone_align_lattice(clat, tm)
    arcs = _phone_arcs(out, tm)
    assert len(arcs) == 1                      # ONE arc for the phone
    olabel, phones = arcs[0]
    assert olabel == 1 and phones == [1] * 6   # complete, labeled
    assert _tid_paths(out) == _tid_paths(clat)


def test_multi_phone_multi_arc_paths_preserved(tm):
    """Phones 1,2,3 spread irregularly over three arcs; output must
    have exactly one arc per phone and identical path weights."""
    t1, t2, t3 = (_phone_tids(tm, p, 4) for p in (1, 2, 3))
    seq = t1 + t2 + t3
    clat = CompactLattice()
    states = [clat.add_state() for _ in range(4)]
    clat.start = states[0]
    # cuts at 3 and 7: phone 1 ends mid-arc-2, phone 2 ends mid-arc-3
    clat.arcs[states[0]].append(
        CompactArc(9, 1.0, 0.5, tuple(seq[:3]), states[1]))
    clat.arcs[states[1]].append(
        CompactArc(0, 0.0, 0.5, tuple(seq[3:7]), states[2]))
    clat.arcs[states[2]].append(
        CompactArc(0, 0.5, 0.0, tuple(seq[7:]), states[3]))
    clat.finals[states[3]] = (0.0, 0.0, ())

    out = phone_align_lattice(clat, tm)
    arcs = _phone_arcs(out, tm)
    assert [(w, set(p)) for w, p in arcs] == [
        (1, {1}), (2, {2}), (3, {3})]
    assert all(len(p) == 4 for _, p in arcs)
    assert _tid_paths(out) == _tid_paths(clat)


def test_keep_words_mode_rides_buffered_words(tm):
    tids = _phone_tids(tm, 2, 3)
    clat = CompactLattice()
    s0, s1, s2 = (clat.add_state() for _ in range(3))
    clat.start = s0
    clat.arcs[s0].append(CompactArc(5, 0.0, 0.0, tuple(tids[:1]), s1))
    clat.arcs[s1].append(CompactArc(0, 0.0, 0.0, tuple(tids[1:]), s2))
    clat.finals[s2] = (0.0, 0.0, ())
    out = phone_align_lattice(clat, tm, replace_output_symbols=False)
    arcs = _phone_arcs(out, tm)
    assert arcs == [(5, [2, 2, 2])]
    assert _tid_paths(out) == _tid_paths(clat)


def test_final_tids_flushed(tm):
    """tids sitting in the final weight's string get aligned too."""
    tids = _phone_tids(tm, 3, 4)
    clat = CompactLattice()
    s0, s1 = clat.add_state(), clat.add_state()
    clat.start = s0
    clat.arcs[s0].append(CompactArc(4, 1.0, 0.0, tuple(tids[:2]), s1))
    clat.finals[s1] = (0.5, 0.25, tuple(tids[2:]))
    out = phone_align_lattice(clat, tm)
    arcs = _phone_arcs(out, tm)
    assert arcs == [(3, [3, 3, 3, 3])]
    assert _tid_paths(out) == _tid_paths(clat)


def test_boost_rejects_frame_mismatch(tm):
    tids = _phone_tids(tm, 1, 5)
    clat = CompactLattice()
    s0, s1 = clat.add_state(), clat.add_state()
    clat.start = s0
    clat.arcs[s0].append(CompactArc(1, 0.0, 0.0, tuple(tids), s1))
    clat.finals[s1] = (0.0, 0.0, ())
    with pytest.raises(KaldiError, match="5 frames.*3"):
        boost_lattice_ali(clat, tm, tids[:3], b=0.1)
    # matching length still works
    out = boost_lattice_ali(clat, tm, tids, b=0.1)
    assert out.arcs[s0][0].graph_cost == pytest.approx(0.0)
