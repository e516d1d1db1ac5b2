"""Demand-triggered escalation (BeamDecoderConfig.escalate_budget).

The retry-with-wider-beam contract (ref: src/decoder/decoder-wrappers.h
DecodeUtteranceLatticeFaster) applied to the BeamDecoder's arc budget:
an utterance whose accumulated beam deficit — Σ_t max(0, lattice_beam −
eff_beam_t) — exceeds escalate_deficit is RE-DECODED at the escalated
budget.  The policy must be honored by every lattice-decode API
(offline single, batch, online finalize, multistream finalize) and its
result must be indistinguishable from a decoder built wide from the
start.
"""

import numpy as np
import pytest

from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig


@pytest.fixture(scope="module")
def task():
    from kaldi_tpu.pipelines.largevocab import make_largevocab_task
    return make_largevocab_task(vocab_size=800, corpus_sentences=800,
                                seed=3)


def _utt(task, rng, n_words=4, noise=0.9):
    from kaldi_tpu.pipelines.largevocab import (sample_eval_set,
                                                synth_loglikes)
    words = list(sample_eval_set(task, 1, max_words=n_words,
                                 seed=int(rng.integers(1 << 30))
                                 ).values())[0]
    return words, synth_loglikes(task, words, rng, noise=noise)


def _cfg(**kw):
    base = dict(beam=14.0, max_active=512, acoustic_scale=1.0,
                lattice_beam=6.0, lattice_arcs_per_frame=1024,
                record_capacity=16384, arc_block=4)
    base.update(kw)
    return BeamDecoderConfig(**base)


TIGHT, WIDE = 512, 4096      # TIGHT = K (the budget floor: 1 blk/token)


@pytest.fixture(scope="module")
def decoders(task):
    t2p = task.tm.tid_to_pdf_array
    tight = BeamDecoder(task.graph.csr, t2p, _cfg(
        arc_budget=TIGHT, escalate_budget=WIDE, escalate_deficit=0.0))
    wide = BeamDecoder(task.graph.csr, t2p, _cfg(arc_budget=WIDE))
    return tight, wide


def _binding_utt(task, decoders, seed=7):
    """An utterance on which the tight budget provably fires the
    deficit trigger (skip-guarded so the test can't pass vacuously)."""
    tight, _ = decoders
    rng = np.random.default_rng(seed)
    for _ in range(8):
        words, ll = _utt(task, rng, n_words=6)
        out = tight._decode_jit(tight._graph_arrays(),
                                np.asarray(ll, np.float32),
                                np.int32(ll.shape[0]))
        host = tight._fetch(out, lattice=True)
        if tight.needs_escalation(host):
            return words, ll, host
    pytest.fail("no utterance fired the deficit trigger; "
                "tighten TIGHT")


def test_trigger_semantics(task, decoders):
    """needs_escalation: fires on positive deficit, never when the
    policy is disabled or the budget is already >= escalate_budget."""
    tight, wide = decoders
    _, ll, host = _binding_utt(task, decoders)
    assert float(host["beam_deficit"]) > 0.0
    assert tight.needs_escalation(host)
    # disabled policy never fires
    off = tight.with_overrides(escalate_budget=0)
    assert not off.needs_escalation(host)
    # a huge deficit threshold never fires
    lazy = tight.with_overrides(escalate_deficit=1e9)
    assert not lazy.needs_escalation(host)
    # escalate_budget <= current budget is a no-op
    noop = tight.with_overrides(escalate_budget=TIGHT)
    assert not noop.needs_escalation(host)
    # an easy utterance (no budget pressure) reports ~zero deficit
    rng = np.random.default_rng(2)
    _, easy = _utt(task, rng, n_words=3, noise=0.1)
    out = wide._decode_jit(wide._graph_arrays(),
                           np.asarray(easy, np.float32),
                           np.int32(easy.shape[0]))
    h = wide._fetch(out, lattice=True)
    assert float(h["beam_deficit"]) == pytest.approx(0.0, abs=1e-4)


def _paths(clat):
    return {w: c for w, c in clat.paths()}


def test_escalated_equals_wide(task, decoders):
    """decode_compact under the policy == a decoder built wide."""
    tight, wide = decoders
    _, ll, _ = _binding_utt(task, decoders)
    got = _paths(tight.decode_compact(ll, bucket=1))
    want = _paths(wide.decode_compact(ll, bucket=1))
    assert set(got) == set(want) and got
    for w in want:
        assert got[w] == pytest.approx(want[w], abs=1e-3)


def test_batch_api_stats_and_quality(task, decoders):
    """decode_compact_batch: per-utterance escalation inside the batch
    API, with the over-pruning diagnostics the bench contract needs
    (min_eff_beam / n_escalated / dropped_arcs)."""
    tight, wide = decoders
    rng = np.random.default_rng(31)
    utts = [_binding_utt(task, decoders)[1]] + \
        [_utt(task, rng, n_words=4)[1] for _ in range(3)]
    Tmax = max(u.shape[0] for u in utts)
    P = task.num_pdfs
    X = np.zeros((len(utts), Tmax, P), np.float32)
    lens = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        X[i, :u.shape[0]] = u
        lens[i] = u.shape[0]
    stats = {}
    lats = tight.decode_compact_batch(X, lens, stats=stats)
    assert stats["n_escalated"] >= 1
    assert np.isfinite(stats["min_eff_beam"])
    assert stats["arcs_peak"] > 0 and stats["heads_peak"] > 0
    assert "dropped_arcs" in stats
    for i, u in enumerate(utts):
        want = _paths(wide.decode_compact(u, bucket=1))
        got = _paths(lats[i])
        # escalated/wide agree exactly; unescalated utts at worst
        # pruned subsets of the wide lattice
        assert set(got) <= set(want)
        gw, gt, gc = lats[i].best_path()
        rw, rt, rc = wide.decode_compact(u, bucket=1).best_path()
        assert gw == rw and gc == pytest.approx(rc, abs=1e-3)


def test_online_finalize_escalates(task, decoders):
    """OnlineBeamDecoder.finalize honors the policy: a stream whose
    deficit fired re-decodes offline at the escalated budget, so the
    final lattice equals the wide decoder's."""
    from kaldi_tpu.decoder.online_beam import OnlineBeamDecoder
    tight, wide = decoders
    _, ll, _ = _binding_utt(task, decoders)
    ob = OnlineBeamDecoder(tight, chunk_frames=16, max_frames=512)
    ob.reset()
    for a in range(0, ll.shape[0], 13):          # ragged chunks
        ob.advance(ll[a:a + 13])
    assert float(ob._deficit) > 0.0
    got = _paths(ob.finalize())
    want = _paths(wide.decode_compact(ll, bucket=16))
    assert set(got) == set(want) and got
    for w in want:
        assert got[w] == pytest.approx(want[w], abs=1e-3)


def test_multistream_finalize_escalates(task, decoders):
    """MultiStreamBeamDecoder: per-channel deficit, per-channel
    escalation at finalize; an easy lane is unaffected."""
    from kaldi_tpu.decoder.online_beam import MultiStreamBeamDecoder
    tight, wide = decoders
    rng = np.random.default_rng(55)
    _, hard, _ = _binding_utt(task, decoders)
    _, easy = _utt(task, rng, n_words=3, noise=0.1)
    ms = MultiStreamBeamDecoder(tight, n_channels=2, chunk_frames=16,
                                max_frames=256)
    pos = [0, 0]
    lls = [hard, easy]
    done = [None, None]
    while any(d is None for d in done):
        chunks = [None, None]
        for c in range(2):
            if done[c] is None:
                chunks[c] = lls[c][pos[c]:pos[c] + 16]
                pos[c] += len(chunks[c])
        ms.advance(chunks)
        for c in range(2):
            if done[c] is None and pos[c] >= lls[c].shape[0]:
                done[c] = ms.finalize_channel(c)
                ms.reset_channel(c)
    assert float(np.asarray(ms._deficit)[0]) == 0.0   # reset cleared it
    got = _paths(done[0])
    want = _paths(wide.decode_compact(hard, bucket=16))
    assert set(got) == set(want) and got
    for w in want:
        assert got[w] == pytest.approx(want[w], abs=1e-3)
    # the easy lane's best path survives untouched
    gw = done[1].best_path()[0]
    rw = wide.decode_compact(easy, bucket=16).best_path()[0]
    assert gw == rw


def test_with_overrides_budget_floor(task, decoders):
    """A clone's arc budget gets the same one-block-per-token floor as
    __init__ (M >= K), so an under-sized retry budget can't break the
    compaction slices."""
    tight, _ = decoders
    clone = tight.with_overrides(arc_budget=64)     # far below K=512
    assert clone.M >= clone.K
    rng = np.random.default_rng(3)
    _, ll = _utt(task, rng, n_words=2, noise=0.1)
    words, _tids, _cost = clone.decode(ll)          # must not crash


def test_escalator_capacity_grows_with_lattice_arcs(task):
    """A small record_capacity must not make _escalator() crash: the
    sibling's capacity grows to cover its (possibly larger)
    lattice_arcs_per_frame (review finding: rc=1024/L=1024 base +
    escalation used to violate with_overrides' rc >= L check)."""
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array, _cfg(
        arc_budget=TIGHT, escalate_budget=16384,
        lattice_arcs_per_frame=1024, record_capacity=1024))
    esc = dec._escalator()
    assert esc.L >= 1024
    assert esc.config.record_capacity >= esc.L


def test_latgen_cli_options():
    """The latgen tools expose the budget/escalation knobs (quality-safe
    defaults must be reachable from the CLI)."""
    from kaldi_tpu.cli.tools import latgen_kwargs, register_latgen_opts
    from kaldi_tpu.core.options import ParseOptions
    po = ParseOptions("test")
    register_latgen_opts(po)
    po.read(["--arc-budget=256", "--escalate-budget=1024",
             "--escalate-deficit=2.5", "--arc-block=8"])
    kw = latgen_kwargs(po)
    assert kw == dict(arc_budget=256, escalate_budget=1024,
                      escalate_deficit=2.5, arc_block=8)
    # defaults are the quality-safe operating point
    po2 = ParseOptions("test")
    register_latgen_opts(po2)
    po2.read([])
    kw2 = latgen_kwargs(po2)
    assert kw2["arc_budget"] == 4096
    assert kw2["escalate_budget"] > kw2["arc_budget"]
    assert kw2["arc_block"] == 8
