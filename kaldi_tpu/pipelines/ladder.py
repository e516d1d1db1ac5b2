"""The falsifiable WER ladder: mono → tri1 → tri2b → tri3b → chain on
a HARD synthetic corpus (confusable minimal-pair lexicon, waveform
noise, per-speaker formant warps, heldout test speakers).

Parity target: the reference's RESULTS-file contract
(egs/mini_librispeech/s5/RESULTS): each system must beat the previous
on a task with nonzero WER.  Round-1's corpora were separable enough
that every system scored 0.00, which validates plumbing but not
modeling.

Runnable:  python -m kaldi_tpu.pipelines.ladder
Prints a stage→WER table; also compares chain with bigram vs trigram
denominator phone LMs.
"""

from __future__ import annotations

import sys
from typing import Dict

import numpy as np

from kaldi_tpu.core.logging import Timer, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.am.chain import make_denominator_graph
from kaldi_tpu.am.tdnn import TdnnConfig
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.transitions import TransitionModel
from kaldi_tpu.am.tree import MonophoneContextDependency
from kaldi_tpu.decoder.dense import DenseDecoder, DenseDecoderConfig
from kaldi_tpu.fst import ArpaModel, arpa_to_fst, make_unigram_arpa, mkgraph
from kaldi_tpu.pipelines import mini
from kaldi_tpu.pipelines.chain import (ChainTrainConfig, ChainTrainer,
                                       make_chain_egs, phone_alignment_runs)
from kaldi_tpu.pipelines.data import confusable_formants, confusable_lexicon
from kaldi_tpu.pipelines.score import compute_wer

log = get_logger(__name__)


def chain_stage(sysd: Dict, order: int, num_epochs: int = 40,
                hidden: int = 96, seed: int = 0):
    """Train + decode an LF-MMI TDNN on the ladder's data, with an
    order-`order` denominator phone LM.

    Supervision comes from the tri3b (SAT) alignments and the features
    are the fMLLR-adapted SAT front-end — the reference's chain recipes
    likewise build supervision from the best GMM and feed the nnet the
    best front-end (steps/nnet3/chain/get_egs.sh uses tri3b lats;
    test-side transforms come from the GMM first pass, the
    decode_fmllr.sh contract)."""
    lang = sysd["lang"]
    train, test = sysd["train"], sysd["test"]
    feats_tr, feats_te = sysd["sat_tr"], sysd["sat_te"]
    gmm_sys = sysd["tri3b"]
    ali = sysd["tri3b_ali"]

    phones = lang.phone_list()
    chain_topo = HmmTopology.chain(phones)
    chain_tree = MonophoneContextDependency(phones, chain_topo)
    phone_seqs = [gmm_sys.tm.alignment_to_phones(ali[u])
                  for u in sorted(ali)]
    den = make_denominator_graph(phone_seqs, chain_tree, chain_topo,
                                 order=order)
    runs = {u: phone_alignment_runs(gmm_sys.tm, ali[u]) for u in ali}
    feat_dim = next(iter(feats_tr.values())).shape[1]
    egs = make_chain_egs(feats_tr, runs, chain_tree, chain_topo,
                         chunk_size=51, subsample=3, den=den)
    cfg = TdnnConfig(feat_dim=feat_dim, num_pdfs=chain_tree.num_pdfs,
                     hidden_dim=hidden, bottleneck_dim=hidden // 4,
                     num_layers=5, frame_subsampling_factor=3)
    trainer = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=num_epochs, batch_size=16, learning_rate=2e-3), seed=seed)
    final = trainer.train(egs, log_every=200)
    log.info("chain(order=%d): objf %.3f", order, final["objf"])

    tm_chain = TransitionModel(chain_topo, chain_tree)
    HCLG = mkgraph(lang, tm_chain, sysd["G"], self_loop_scale=1.0)
    dec = DenseDecoder(HCLG, tm_chain.tid_to_pdf_array,
                       DenseDecoderConfig(beam=16.0, acoustic_scale=1.0))
    scorer = trainer.scores_fn()
    hyps = {}
    for u in sorted(feats_te):
        scores = np.asarray(scorer(feats_te[u][None]))[0]
        _, ols, _ = dec.decode(scores.astype(np.float32))
        hyps[u] = [lang.words.find(o) for o in ols]
    return compute_wer(test.text, hyps)


def run(num_utts: int = 100, num_test: int = 30, seed: int = 1,
        noise: float = 0.12, speaker_warp: float = 0.12,
        chain_epochs: int = 40, coarticulation: float = 0.35,
        num_words: int = 0):
    """``num_words`` ≥ 12 swaps the hand-written 12-word lexicon for a
    GENERATED confusable lexicon of that size (spectral-cluster
    minimal pairs, pipelines/flagship.flagship_lexicon) with a bigram
    G estimated from the training transcripts — so LM disambiguation,
    homophone pruning and lexical branching are real.  0 keeps the legacy 12-word corpus."""
    timer = Timer()
    if num_words:
        from kaldi_tpu.pipelines.flagship import flagship_lexicon
        from kaldi_tpu.fst.lang import Lexicon
        entries, formants = flagship_lexicon(
            num_words, n_clusters=8, per_cluster=3, min_len=2,
            max_len=5, seed=seed + 17)
        lexicon = Lexicon(sorted(entries))
        lm_order = 2
    else:
        lexicon, formants = confusable_lexicon(), confusable_formants()
        lm_order = 1
    # tree size scales with the corpus, as Kaldi recipes tune
    # <num-leaves> <tot-gauss> per corpus: swept at ~100 utts, 30
    # leaves/600 gauss generalizes best (100-leaf trees over-split and
    # regress below mono); grow ~linearly beyond that.
    leaves = max(30, num_utts // 4)
    # Speaker count must scale with the corpus: with only 4 training
    # speakers the triphone tree's context splits latch onto speaker
    # idiosyncrasies (the warp) instead of coarticulation, and tri1
    # regresses below mono on heldout speakers at ≥400 utts — the
    # leaves sweep showed the regression at EVERY tree size, so it is
    # a data property, not a tuning one.  Kaldi corpora have hundreds
    # of speakers (mini_librispeech: 118 train).
    n_spk = max(4, num_utts // 20)
    n_tspk = max(3, num_test // 20)
    wers, sysd = mini.run(
        num_utts=num_utts, num_test=num_test, seed=seed,
        lexicon=lexicon, noise=noise,
        speaker_warp=speaker_warp, heldout_speakers=True,
        formants=formants, return_systems=True,
        tri_leaves=leaves, tri_gauss=20 * leaves,
        coarticulation=coarticulation,
        num_speakers=n_spk, num_test_speakers=n_tspk,
        lm_order=lm_order)
    # den-LM order rung RETIRED: trigram-vs-
    # bigram den LMs sat within the Wilson interval two rounds
    # running at this corpus size — the rung cannot resolve here, so
    # the ladder reports one chain system at the product default
    # (order 3, matching chain-est-phone-lm); re-add order=2 via
    # chain_stage(sysd, order=2) if a larger eval ever makes the
    # comparison meaningful.
    wers["chain"] = chain_stage(sysd, order=3,
                                num_epochs=chain_epochs)
    from kaldi_tpu.pipelines.score import wilson_interval
    print("\n== WER ladder (noise %.2f, warp %.2f, heldout speakers) =="
          % (noise, speaker_warp))
    for stage in ("mono", "tri1", "tri2b", "tri3b", "chain"):
        r = wers[stage]
        lo, hi = wilson_interval(r.errors, r.ref_words)
        print(f"  {stage:12s} {r}  wilson95=[{lo:.2f}, {hi:.2f}]")
    log.info("ladder done in %.0fs", timer.elapsed())
    return wers


def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu.pipelines.ladder")
    po.register("num-utts", int, 100, "training utterances")
    po.register("num-test", int, 30, "test utterances")
    po.register("noise", float, 0.12, "waveform noise level")
    po.register("speaker-warp", float, 0.12, "per-speaker formant warp")
    po.register("chain-epochs", int, 40, "chain training epochs")
    po.register("num-words", int, 0,
                "generated confusable lexicon size (0 = legacy 12)")
    po.read(argv)
    wers = run(num_utts=po["num-utts"], num_test=po["num-test"],
               noise=po["noise"], speaker_warp=po["speaker-warp"],
               chain_epochs=po["chain-epochs"],
               num_words=po["num-words"])
    ladder = [wers[s].wer for s in
              ("mono", "tri1", "tri2b", "tri3b")]
    ok = wers["mono"].wer > 0 and ladder[-1] <= ladder[0]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
