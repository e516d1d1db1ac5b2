"""Chain (LF-MMI) recipe driven ONLY through the CLI tool layer, with
ark/scp artifacts between every stage.

Parity target: the egs/wsj/s5/steps/nnet3/chain/train.py stage
contract: every processing step below is a
`kaldi_tpu.cli` TOOLS invocation reading and writing disk artifacts —
exactly the boundary a user scripting the framework sees.  Python
code only synthesizes the corpus (local/ data prep, as in
wav_recipe.py) and sequences the tool calls (the run.sh role).

Stages (tool per arrow):
  0 local/:        wavs + data dir + lexicon.txt + lm.arpa on disk
  1 features:      compute-mfcc-feats → compute-cmvn-stats →
                   apply-cmvn → add-deltas          (ark,scp)
  2 mono GMM:      gmm-init-mono → compile-train-graphs →
                   align-equal-compiled → {gmm-acc-stats-ali →
                   gmm-est → gmm-align-compiled}*   (exp/mono)
  3 chain prep:    gmm-init-mono(chain topo) → convert-ali →
                   ali-to-phones                    (exp/chain)
  4 egs:           nnet3-chain-get-egs → nnet3-chain-shuffle-egs
  5 train:         nnet3-init → nnet3-chain-train   (final.raw)
  6 graph:         arpa2fst → compile-graph         (HCLG.fst)
  7 decode:        nnet3-latgen-faster              (lat.ark)
  8 score:         lattice-best-path → compute-wer

Runnable:  python -m kaldi_tpu.pipelines.chain_cli_recipe
"""

from __future__ import annotations

import os
import sys

import numpy as np

from kaldi_tpu.core.logging import KaldiError, Timer, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.core.table import SequentialTableReader
from kaldi_tpu.pipelines.score import compute_wer
from kaldi_tpu.pipelines.wav_recipe import (final_feats, make_mfcc,
                                            prepare_corpus)

log = get_logger(__name__)


def _run(name, argv):
    from kaldi_tpu.cli import TOOLS
    rc = TOOLS[name](argv)
    if rc:
        raise KaldiError(f"{name} failed (rc={rc})")


def _write_topo(path: str, topo) -> None:
    from kaldi_tpu.am.serialize import write_topology
    with open(path, "wb") as f:
        f.write(b"\0B")
        write_topology(f, topo)


def run(work: str, num_utts: int = 40, num_test: int = 12,
        mono_iters: int = 8, chain_epochs: int = 8,
        hidden: int = 48, seed: int = 1):
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.fst import Lang, make_unigram_arpa
    from kaldi_tpu.pipelines.data import yesno_lexicon
    from kaldi_tpu.pipelines.datadir import read_data_dir

    timer = Timer()
    lex = yesno_lexicon()
    lang = Lang(lex)

    # ---- stage 0: local/ data prep (files on disk) -----------------
    train_d = prepare_corpus(work, "train", lex, num_utts, seed=seed)
    test_d = prepare_corpus(work, "test", lex, num_test, seed=seed + 1)
    lang_dir = os.path.join(work, "lang")
    os.makedirs(lang_dir, exist_ok=True)
    lex_txt = os.path.join(lang_dir, "lexicon.txt")
    with open(lex_txt, "w") as f:
        for word, pron in lex.entries:
            f.write(word + " " + " ".join(pron) + "\n")
    arpa_path = os.path.join(lang_dir, "lm.arpa")
    with open(arpa_path, "w") as f:
        f.write(make_unigram_arpa({w: 1.0 for w, _ in lex.entries}))
    words_txt = os.path.join(lang_dir, "words.txt")
    lang.words.write(words_txt)
    phones = lang.phone_list()
    topo3 = os.path.join(lang_dir, "topo")
    _write_topo(topo3, HmmTopology.three_state(phones))
    topo_chain = os.path.join(lang_dir, "topo_chain")
    _write_topo(topo_chain, HmmTopology.chain(phones))
    log.info("stage 0: corpus + lang on disk (%.1fs)", timer.elapsed())

    # ---- stage 1: features through the CLI -------------------------
    mfcc_dir = os.path.join(work, "mfcc")
    make_mfcc(train_d, mfcc_dir)
    make_mfcc(test_d, mfcc_dir)
    tr_scp = final_feats(train_d, mfcc_dir)
    te_scp = final_feats(test_d, mfcc_dir)
    dim = next(iter(SequentialTableReader(f"scp:{tr_scp}",
                                          holder="mat")))[1].shape[1]
    log.info("stage 1: features dim %d (%.1fs)", dim, timer.elapsed())

    # ---- stage 2: mono GMM training loop, all tools ---------------
    exp = os.path.join(work, "exp", "mono")
    os.makedirs(exp, exist_ok=True)
    mdl0 = os.path.join(exp, "0.mdl")
    tree0 = os.path.join(exp, "tree")
    _run("gmm-init-mono", [f"--train-feats=scp:{tr_scp}", topo3,
                           str(dim), mdl0, tree0])
    graphs = os.path.join(exp, "graphs.ark")
    text_ark = f"ark,t:{train_d}/text"
    _run("compile-train-graphs", [lex_txt, mdl0, text_ark,
                                  f"ark:{graphs}"])
    ali = os.path.join(exp, "ali.0.ark")
    _run("align-equal-compiled", [f"ark:{graphs}", f"scp:{tr_scp}",
                                  f"ark:{ali}"])
    cur = mdl0
    for it in range(mono_iters):
        accs = os.path.join(exp, f"{it}.acc")
        _run("gmm-acc-stats-ali", [cur, f"scp:{tr_scp}", f"ark:{ali}",
                                   accs])
        nxt = os.path.join(exp, f"{it + 1}.mdl")
        _run("gmm-est", ["--mix-up=0", cur, accs, nxt])
        cur = nxt
        if it % 2 == 1:
            ali = os.path.join(exp, f"ali.{it + 1}.ark")
            _run("gmm-align-compiled",
                 [cur, f"ark:{graphs}", f"scp:{tr_scp}", f"ark:{ali}"])
    mono_mdl = os.path.join(exp, "final.mdl")
    _run("gmm-copy", [cur, mono_mdl])
    log.info("stage 2: mono GMM trained (%.1fs)", timer.elapsed())

    # ---- stage 3: chain transition model + converted alignments ---
    chain_dir = os.path.join(work, "exp", "chain")
    os.makedirs(chain_dir, exist_ok=True)
    chain_mdl = os.path.join(chain_dir, "0.mdl")
    chain_tree = os.path.join(chain_dir, "tree")
    _run("gmm-init-mono", [f"--train-feats=scp:{tr_scp}", topo_chain,
                           str(dim), chain_mdl, chain_tree])
    # chain supervision is phone-level: the GMM's alignment feeds
    # get-egs directly (the get_egs.sh contract); no cross-topology
    # tid conversion
    phone_seqs = os.path.join(chain_dir, "phones.ark")
    _run("ali-to-phones", [mono_mdl, f"ark:{ali}",
                           f"ark:{phone_seqs}"])
    log.info("stage 3: chain model + phone supervision (%.1fs)",
             timer.elapsed())

    # ---- stage 4: egs ---------------------------------------------
    egs0 = os.path.join(chain_dir, "egs.raw.ark")
    _run("nnet3-chain-get-egs",
         ["--chunk-size=30", "--frame-subsampling-factor=3",
          f"--ali-model={mono_mdl}",
          chain_mdl, f"scp:{tr_scp}", f"ark:{ali}",
          f"ark:{egs0}"])
    egs = os.path.join(chain_dir, "egs.ark")
    _run("nnet3-chain-shuffle-egs", ["--srand=7", f"ark:{egs0}",
                                     f"ark:{egs}"])
    log.info("stage 4: egs extracted (%.1fs)", timer.elapsed())

    # ---- stage 5: nnet3-chain-train -------------------------------
    raw0 = os.path.join(chain_dir, "0.raw")
    from kaldi_tpu.am.serialize import read_mdl
    num_pdfs = read_mdl(chain_mdl)[0].num_pdfs
    _run("nnet3-init", [f"--feat-dim={dim}", f"--num-pdfs={num_pdfs}",
                        f"--hidden-dim={hidden}",
                        f"--bottleneck-dim={hidden // 4}",
                        "--num-layers=3", raw0])
    final_raw = os.path.join(chain_dir, "final.raw")
    _run("nnet3-chain-train",
         [f"--num-epochs={chain_epochs}", "--learning-rate=2e-3",
          "--lm-order=2", chain_mdl, raw0, f"ark:{phone_seqs}",
          f"ark:{egs}", final_raw])
    log.info("stage 5: chain model trained (%.1fs)", timer.elapsed())

    # ---- stage 6: decode graph ------------------------------------
    graph_dir = os.path.join(chain_dir, "graph")
    os.makedirs(graph_dir, exist_ok=True)
    g_fst = os.path.join(graph_dir, "G.fst")
    _run("arpa2fst", [f"--read-symbol-table={words_txt}", arpa_path,
                      g_fst])
    hclg = os.path.join(graph_dir, "HCLG.fst")
    _run("compile-graph", ["--self-loop-scale=1.0", lex_txt,
                           chain_mdl, g_fst, hclg])
    log.info("stage 6: HCLG.fst on disk (%.1fs)", timer.elapsed())

    # ---- stage 7: decode ------------------------------------------
    dec_dir = os.path.join(chain_dir, "decode_test")
    os.makedirs(dec_dir, exist_ok=True)
    lat_ark = os.path.join(dec_dir, "lat.1.ark")
    _run("nnet3-latgen-faster",
         ["--beam=16.0", "--acoustic-scale=1.0",
          "--frame-subsampling-factor=3",
          f"--word-symbol-table={words_txt}", chain_mdl, final_raw,
          hclg, f"scp:{te_scp}", f"ark:{lat_ark}"])
    log.info("stage 7: decoded (%.1fs)", timer.elapsed())

    # ---- stage 8: score -------------------------------------------
    tra = os.path.join(dec_dir, "tra.txt")
    _run("lattice-best-path",
         [f"--word-symbol-table={words_txt}", f"ark:{lat_ark}",
          f"ark,t:{tra}"])
    hyps = dict(SequentialTableReader(f"ark,t:{tra}", holder="text"))
    refs = read_data_dir(test_d).text
    wer = compute_wer(refs, hyps)
    log.info("stage 8: %s (%.1fs total)", wer, timer.elapsed())
    print(wer)
    return wer


def main(argv=None):
    po = ParseOptions(
        "Usage: python -m kaldi_tpu.pipelines.chain_cli_recipe")
    po.register("work-dir", str, "/tmp/kaldi_tpu_chain_cli",
                "working directory")
    po.register("num-utts", int, 40, "training utterances")
    po.register("chain-epochs", int, 8, "chain training epochs")
    po.read(argv)
    wer = run(po["work-dir"], num_utts=po["num-utts"],
              chain_epochs=po["chain-epochs"])
    return 0 if wer.wer < 20.0 else 1


if __name__ == "__main__":
    sys.exit(main())
