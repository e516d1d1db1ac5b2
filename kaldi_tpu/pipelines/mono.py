"""Monophone GMM-HMM training.

Parity target: egs/wsj/s5/steps/train_mono.sh driving gmm-init-mono,
compile-train-graphs, align-equal-compiled, gmm-acc-stats-ali,
gmm-est, gmm-align-compiled (SURVEY.md §3.1 call stack).

Shape: per-iteration work is two batched device programs —
(a) GMM log-likelihood evaluation + dense Viterbi alignment over all
utterances, (b) sufficient-stat accumulation via segment-sums — with
host-side MLE updates.  Stats across data shards combine by addition
(the psum analogue of gmm-sum-accs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu.core.logging import get_logger
from kaldi_tpu.am.gmm import (
    AmDiagGmm,
    GmmAccs,
    accumulate_stats,
    global_stats,
    mixup,
    mle_update,
)
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.transitions import TransitionModel
from kaldi_tpu.am.tree import MonophoneContextDependency
from kaldi_tpu.decoder.align import DenseAligner, in_degrees, pack_dense_reverse
from kaldi_tpu.decoder.training_graph import TrainingGraphCompiler, equal_align
from kaldi_tpu.fst.lang import Lang
from kaldi_tpu.pipelines.data import DataSet

log = get_logger(__name__)


@dataclasses.dataclass
class MonoTrainConfig:
    num_iters: int = 20
    max_iter_inc: int = 12          # iterations over which #gauss grows
    totgauss: int = 300
    realign_iters: Sequence[int] = tuple(
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18])
    self_loop_scale: float = 0.1
    transition_scale: float = 1.0
    acoustic_scale: float = 1.0     # alignment uses scale 1 like the ref
    beam: float = 1e9               # dense aligner is exact anyway
    perturb_factor: float = 0.01


@dataclasses.dataclass
class MonoModel:
    am: AmDiagGmm
    tm: TransitionModel
    lang: Lang


def train_mono(feats: Dict[str, np.ndarray], text: Dict[str, List[str]],
               lang: Lang, config: MonoTrainConfig = None) -> MonoModel:
    """feats: utt → (T, D) feature matrix (already CMVN'd etc.)."""
    cfg = config or MonoTrainConfig()
    phones = lang.phone_list()
    topo = HmmTopology.three_state(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    utts = sorted(feats)

    # flat start (gmm-init-mono)
    gmean, gvar = global_stats(feats[u] for u in utts)
    am = AmDiagGmm.flat_start(tree.num_pdfs, gmean, gvar,
                              perturb=cfg.perturb_factor)

    # training graphs (compile-train-graphs)
    compiler = TrainingGraphCompiler(lang, tm, cfg.transition_scale,
                                     cfg.self_loop_scale)
    graphs = {u: compiler.compile_text(text[u]) for u in utts}
    ae = max(in_degrees(g)[0] for g in graphs.values())
    an = max(max(in_degrees(g)[1] for g in graphs.values()), 1)
    smax = max(g.num_states for g in graphs.values())
    dense = {u: pack_dense_reverse(graphs[u], smax, ae, an) for u in utts}

    # equal alignment (align-equal-compiled)
    ali: Dict[str, List[int]] = {}
    for u in utts:
        ali[u] = equal_align(graphs[u], feats[u].shape[0])

    aligner = DenseAligner(tm.tid_to_pdf_array,
                           acoustic_scale=cfg.acoustic_scale)

    gauss_inc = max(0, (cfg.totgauss - am.num_gauss())) // max(
        cfg.max_iter_inc, 1)

    def accumulate_all() -> Tuple[GmmAccs, np.ndarray]:
        # all utterances concatenated into ONE device call (a constant
        # total frame count -> one compilation, and the segment-sums
        # batch all frames together)
        accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
        tid_counts = np.zeros(tm.num_transition_ids + 1)
        all_feats = np.concatenate([feats[u] for u in utts])
        all_tids = np.concatenate([np.asarray(ali[u]) for u in utts])
        pdf_ali = tm.tid_to_pdf_array[all_tids]
        accumulate_stats(am, all_feats, pdf_ali, accs)
        tid_counts += np.bincount(all_tids,
                                  minlength=tm.num_transition_ids + 1)
        return accs, tid_counts

    for it in range(cfg.num_iters):
        if it in cfg.realign_iters and it > 0:
            aligner.acoustic_scale = cfg.acoustic_scale
            lls = [np.asarray(am.loglikes(feats[u])) for u in utts]
            results = aligner.align_batch([dense[u] for u in utts], lls)
            for u, (tids, cost) in zip(utts, results):
                ali[u] = tids
        accs, tid_counts = accumulate_all()
        mle_update(am, accs)
        tm.mle_update(tid_counts)
        if it < cfg.max_iter_inc and am.num_gauss() < cfg.totgauss:
            am = mixup(am, am.num_gauss() + gauss_inc,
                       perturb=cfg.perturb_factor, seed=it)
        log.info("train_mono iter %d: %d gauss, avg loglike/frame %.3f",
                 it, am.num_gauss(),
                 accs.tot_like / max(accs.tot_frames, 1))
    return MonoModel(am, tm, lang)
