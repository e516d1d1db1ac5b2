"""Hard-corpus lattice-QUALITY benchmark: large-vocabulary decoding
under real acoustic ambiguity, reporting 1-best WER, ORACLE (lattice)
WER, and lattice density across decoder budget operating points.

The round-2 verdict's top item: the throughput bench ran on a corpus
whose eval WER was 0.00, so the arc-budget cutoff's effect on LATTICE
quality was unmeasured.  This module makes the task hard enough to be
falsifiable — a confusable lexicon (words come in families differing
in one phone, the minimal-pair structure real lexicons have), fewer
phones, and an acoustic noise level that puts 1-best WER in the
5–20 % band — then sweeps ``arc_budget`` / ``max_active`` and scores
each operating point the way the reference's lattice tooling would:

  * %WER        — compute-wer on lattice best paths
  * oracle %WER — latbin/lattice-oracle.cc role: min edit distance
                  over ALL lattice paths (lattice/functions.py
                  oracle_errors)
  * density     — latbin/lattice-depth.cc role: arc-frames per
                  utterance frame

Acceptance: the default 4096 arc-budget point must
lose <0.1 oracle WER absolute vs the loosest budget on a task whose
1-best WER is nonzero.

Runnable:  python -m kaldi_tpu.pipelines.hard [--sweep=true]
Emits one JSON line per operating point (one record schema for every operating point).
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu.core.logging import Timer, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.lattice.functions import lattice_depth, oracle_errors
from kaldi_tpu.pipelines.largevocab import (LargeVocabTask,
                                            make_largevocab_task,
                                            sample_eval_set,
                                            synth_loglikes)
from kaldi_tpu.pipelines.score import compute_wer

log = get_logger(__name__)


def confusable_entries(vocab_size: int = 20000, num_phones: int = 24,
                       variants: int = 8, min_len: int = 3,
                       max_len: int = 7, seed: int = 11
                       ) -> List[Tuple[str, List[str]]]:
    """Lexicon of ``vocab_size`` words in families of ``variants``
    near-minimal pairs: each family shares a base pronunciation and
    every variant substitutes one phone, so family members differ in
    ≤2 positions — the lattice must keep whole confusion sets alive.
    A reduced phone inventory (24 vs the easy task's 40) raises the
    cross-family collision rate too."""
    rng = np.random.default_rng(seed)
    phones = [f"p{i:02d}" for i in range(num_phones)]
    entries: List[Tuple[str, List[str]]] = []
    wid = 0
    while wid < vocab_size:
        L = int(rng.integers(min_len, max_len + 1))
        base = rng.integers(0, num_phones, L)
        for v in range(variants):
            if wid >= vocab_size:
                break
            pron = base.copy()
            if v > 0:
                pron[int(rng.integers(0, L))] = int(
                    rng.integers(0, num_phones))
            entries.append((f"w{wid:05d}",
                            [phones[int(k)] for k in pron]))
            wid += 1
    return entries


def make_hard_task(vocab: int = 20000, order: int = 3, seed: int = 7,
                   num_phones: int = 24, variants: int = 8,
                   **kw) -> LargeVocabTask:
    entries = confusable_entries(vocab, num_phones=num_phones,
                                 variants=variants, seed=seed + 4)
    return make_largevocab_task(vocab_size=vocab, order=order,
                                seed=seed, closure=False,
                                entries=entries, **kw)


def synth_eval(task: LargeVocabTask, n_utts: int, noise: float,
               peak: float, seed: int = 99, max_words: int = 12
               ) -> Tuple[Dict[str, List[str]], Dict[str, np.ndarray]]:
    eval_set = sample_eval_set(task, n_utts, max_words=max_words,
                               seed=seed)
    rng = np.random.default_rng(seed + 999)
    lls = {u: synth_loglikes(task, s, rng, noise=noise, peak=peak)
           for u, s in eval_set.items()}
    return eval_set, lls


def _batches(lls: Dict[str, np.ndarray], num_pdfs: int, B: int,
             bucket: int):
    """Length-sorted batches, T padded UP to a multiple of ``bucket``
    — the shape-bucket policy that bounds the number of distinct
    compiled executables (real deployments vary
    shapes; coarse buckets mean a handful of compiles, paid once into
    the persistent cache)."""
    utts = sorted(lls, key=lambda u: (len(lls[u]), u))
    out = []
    for i in range(0, len(utts), B):
        chunk = utts[i:i + B]
        T_pad = int(np.ceil(max(len(lls[u]) for u in chunk)
                            / bucket) * bucket)
        Xb = np.zeros((B, T_pad, num_pdfs), np.float32)
        lb = np.zeros(B, np.int32)
        for b, u in enumerate(chunk):
            Xb[b, :len(lls[u])] = lls[u]
            lb[b] = len(lls[u])
        out.append((chunk, Xb, lb))
    return out


def decode_eval(task: LargeVocabTask, lls: Dict[str, np.ndarray],
                beam: float = 13.0, max_active: int = 7000,
                lattice_beam: float = 7.0, arc_budget: int = 4096,
                token_capacity: int = 4096, batch: int = 32,
                bucket: int = 96, record_capacity: int = 0,
                arc_block: int = 8, escalate_budget: int = 0,
                escalate_deficit: float = 4.0,
                pool: Optional[ThreadPoolExecutor]
                = None) -> Tuple[Dict[str, object], Dict[str, float]]:
    """Decode every utterance to a determinized CompactLattice at one
    operating point; returns (utt → lattice, stats).

    ``escalate_budget`` > arc_budget enables the PRODUCT escalation
    policy (BeamDecoderConfig.escalate_budget/escalate_deficit —
    it moved out of this harness into the
    decoder): an utterance whose accumulated beam deficit exceeds
    ``escalate_deficit`` is RE-DECODED at the wider budget — the
    retry-with-wider-beam contract (gmm-align-compiled --retry-beam)
    applied to the arc budget.  Throughput accounting includes the
    retries."""
    from kaldi_tpu.decoder.beam import (BUILD_TIMERS, BeamDecoder,
                                        BeamDecoderConfig)
    from kaldi_tpu.core.jit_cache import enable as enable_jit_cache
    import jax

    enable_jit_cache()
    BUILD_TIMERS.reset()

    # decoder invariants: token_capacity ≤ arc_budget (a token expands
    # ≥1 arc) and token_capacity ≤ lattice_arcs_per_frame ≤ arc_budget
    # (records are chosen among the M expanded arcs; every Viterbi arc
    # must fit)
    token_capacity = min(token_capacity, arc_budget)
    cfg = BeamDecoderConfig(beam=beam, max_active=max_active,
                            acoustic_scale=1.0,
                            lattice_beam=lattice_beam,
                            arc_budget=arc_budget,
                            token_capacity=token_capacity,
                            arc_block=arc_block,
                            escalate_budget=escalate_budget,
                            escalate_deficit=escalate_deficit,
                            lattice_arcs_per_frame=min(4096, arc_budget),
                            # capacity 0 = uncapped record buffer: the
                            # fetch slices exactly n_max records, so a
                            # hard corpus can never overflow — the
                            # quality sweep trades the async-copy
                            # overlap (bench.py's throughput path) for
                            # robustness at any lattice density
                            record_capacity=record_capacity)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array, cfg)
    gd = dec._graph_arrays()
    batches = _batches(lls, task.num_pdfs, batch, bucket)
    t0 = time.time()
    compiled = {Xb.shape: dec._get_compiled(Xb.shape)
                for _, Xb, _ in batches}
    compile_s = time.time() - t0
    # escalated-sibling programs compile in the BACKGROUND, overlapped
    # with the base decode (the retry program's cold compile would
    # otherwise sit ON the critical path); only time actually
    # spent blocking on an unfinished compile is charged below
    esc_prewarm = dec.prewarm_escalator({Xb.shape for _, Xb, _
                                         in batches})
    own_pool = pool is None
    if own_pool:
        pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count()
                                                  or 4))
    stats = {"compile_s": compile_s, "shapes": len(compiled),
             "arcs_peak": 0, "heads_peak": 0, "dropped": 0,
             # frames where the arc budget imposed an effective beam
             # below lattice_beam lose lattice arcs (the oracle-WER
             # mechanism); min over the whole eval = worst case
             "min_eff_beam": float("inf"), "n_escalated": 0}
    lats: Dict[str, object] = {}
    t0 = time.perf_counter()

    def decode_all(decoder, batch_list, exes):
        """One sweep over batches: decode, flag, build.  Returns the
        utterances whose effective beam dipped below lattice_beam."""
        outs = []
        for chunk, Xb, lb in batch_list:
            out = exes[Xb.shape](gd, Xb, lb)
            decoder.start_fetch(out, lattice=True)
            outs.append((chunk, Xb, out))
        # NOTE: no barrier here — batch i's D2H fetch overlaps batch
        # i+1's device compute (the r4 pipeline; an earlier profiling
        # barrier at this spot serialized them and cost ~20% wall)
        futs, flagged = [], []
        for chunk, Xb, out in outs:
            stats["arcs_peak"] = max(
                stats["arcs_peak"],
                int(np.asarray(out["max_arcs_demand"]).max()))
            stats["heads_peak"] = max(
                stats["heads_peak"],
                int(np.asarray(out["max_heads"]).max()))
            hosts = decoder._fetch_batch(out, len(chunk), lattice=True)
            for b, (u, host) in enumerate(zip(chunk, hosts)):
                eff = float(host["min_eff_beam"])
                stats["min_eff_beam"] = min(stats["min_eff_beam"], eff)
                # the PRODUCT trigger (deficit-based, see
                # BeamDecoder.needs_escalation) — this harness batches
                # the retries itself for throughput accounting
                if decoder is dec and dec.needs_escalation(host):
                    flagged.append(u)
                    continue
                stats["dropped"] += int(host["dropped_arcs"])
                futs.append((u, pool.submit(
                    decoder.build_compact_lattice, host,
                    int(len(lls[u])), Xb[b])))
        for u, f in futs:
            lats[u] = f.result()
        return flagged

    flagged = decode_all(dec, batches, compiled)
    if flagged:
        stats["n_escalated"] = len(flagged)
        esc = dec._escalator()
        esc_batches = _batches({u: lls[u] for u in flagged},
                               task.num_pdfs, batch, bucket)
        tc = time.perf_counter()
        esc_exes = {}
        for _, Xb, _ in esc_batches:
            f = (esc_prewarm or {}).get(Xb.shape)
            esc_exes[Xb.shape] = (f.result() if f is not None
                                  else esc._get_compiled(Xb.shape))
        # blocking time only: the prewarm ran concurrently with the
        # base decode, so a finished compile costs ~0 here
        esc_compile = time.perf_counter() - tc
        stats["esc_compile_wait_s"] = round(esc_compile, 2)
        stats["compile_s"] += esc_compile
        t0 += esc_compile        # throughput excludes compiles (cached)
        decode_all(esc, esc_batches, esc_exes)
    stats["wall_s"] = time.perf_counter() - t0
    stats["audio_s"] = sum(len(x) for x in lls.values()) * 0.03
    # host-stage attribution (fetch = device-wait + link; records /
    # raw-build / determinize accumulate across the build pool's
    # threads, so their SUM can exceed wall when overlapped)
    for k, v in BUILD_TIMERS.reset().items():
        stats[k] = round(v, 3)
    # link-independent device time: re-run the first batch compute-
    # only (program cached, graph resident) and block — decode wall
    # minus the fetch; scaled to all batches
    if batches:
        _, Xb0, lb0 = batches[0]
        o = compiled[Xb0.shape](gd, Xb0, lb0)
        o["beam_deficit"].block_until_ready()           # warm
        td = time.perf_counter()
        o = compiled[Xb0.shape](gd, Xb0, lb0)
        o["beam_deficit"].block_until_ready()
        stats["device_s_per_batch"] = time.perf_counter() - td
        stats["device_s"] = round(
            stats["device_s_per_batch"] * len(batches), 3)
        stats["device_audio_s_per_s"] = round(
            stats["audio_s"] / max(stats["device_s"], 1e-9), 1)
    if own_pool:
        pool.shutdown()
    return lats, stats


def score_lattices(task: LargeVocabTask,
                   eval_set: Dict[str, List[str]],
                   lats: Dict[str, object]):
    """(wer_result, oracle%, density) over the eval set."""
    hyps, orc_err, orc_words = {}, 0, 0
    depth_num = depth_den = 0
    for u, lat in lats.items():
        hyps[u] = [task.words.find(o) for o in lat.best_path()[0]]
        ref_ids = [task.words[w] for w in eval_set[u]]
        orc_err += oracle_errors(lat, ref_ids)
        orc_words += len(ref_ids)
        dn, dd = lattice_depth(lat)
        depth_num += dn
        depth_den += dd
    wer = compute_wer(eval_set, hyps)
    oracle = 100.0 * orc_err / max(orc_words, 1)
    density = depth_num / max(depth_den, 1)
    return wer, oracle, density


def run_point(task, eval_set, lls, pool=None, **knobs):
    lats, stats = decode_eval(task, lls, pool=pool, **knobs)
    wer, oracle, density = score_lattices(task, eval_set, lats)
    rec = {
        "metric": "hard_corpus_lattice_quality",
        "arc_budget": knobs.get("arc_budget", 4096),
        "arc_block": knobs.get("arc_block", 8),
        "max_active": knobs.get("max_active", 7000),
        "wer": round(wer.wer, 2),
        "oracle_wer": round(oracle, 2),
        "density": round(density, 2),
        "audio_s_per_s": round(stats["audio_s"] / stats["wall_s"], 1),
        "dropped_arcs": stats["dropped"],
        "arcs_peak": stats["arcs_peak"],
        "heads_peak": stats["heads_peak"],
        "min_eff_beam": round(stats["min_eff_beam"], 2),
        "compile_s": round(stats["compile_s"], 1),
        "wall_s": round(stats["wall_s"], 2),
    }
    for k in ("device_s", "fetch_s", "records_s", "raw_build_s",
              "determinize_s", "device_audio_s_per_s", "fetch_bytes",
              "esc_compile_wait_s"):
        if k in stats:
            rec[k] = round(stats[k], 2)
    if knobs.get("escalate_budget"):
        rec["escalate_budget"] = knobs["escalate_budget"]
        rec["n_escalated"] = stats["n_escalated"]
    log.info("hard point %s", rec)
    return rec


def run_sweep(vocab: int = 20000, n_utts: int = 1200,
              noise: float = 1.0, peak: float = 4.0,
              budgets=(2048, 4096, 12288), actives=(7000, 2000),
              max_words: int = 16, seed: int = 7):
    """The acceptance sweep: arc_budget ∈ budgets at max_active
    7000, plus a max_active point at the default budget."""
    timer = Timer()
    task = make_hard_task(vocab=vocab, seed=seed)
    eval_set, lls = synth_eval(task, n_utts, noise=noise, peak=peak,
                               max_words=max_words)
    n_words = sum(len(s) for s in eval_set.values())
    log.info("hard corpus: %d utts / %d ref words / %.0f audio-s "
             "(graph %d states, %d arcs)", len(eval_set), n_words,
             sum(len(x) for x in lls.values()) * 0.03,
             task.graph.csr.num_states,
             task.graph.csr.num_emitting_arcs
             + task.graph.csr.num_eps_arcs)
    pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 4))
    results = []
    for ab in budgets:
        results.append(run_point(task, eval_set, lls, pool=pool,
                                 arc_budget=ab, max_active=7000))
    for ma in actives:
        if ma == 7000:
            continue                      # covered by the budget sweep
        results.append(run_point(task, eval_set, lls, pool=pool,
                                 arc_budget=4096, max_active=ma))
    pool.shutdown()
    log.info("hard sweep done in %.0fs", timer.elapsed())
    for r in results:
        print(json.dumps(r))
    return results


def main(argv=None):
    po = ParseOptions("Usage: python -m kaldi_tpu.pipelines.hard")
    po.register("vocab", int, 20000, "vocabulary size")
    po.register("num-utts", int, 1000, "eval utterances")
    po.register("noise", float, 1.0, "acoustic noise (WER knob)")
    po.register("peak", float, 4.0, "true-pdf loglike margin")
    po.register("sweep", bool, True, "run the full budget sweep")
    po.read(argv)
    if po["sweep"]:
        run_sweep(vocab=po["vocab"], n_utts=po["num-utts"],
                  noise=po["noise"], peak=po["peak"])
    else:
        task = make_hard_task(vocab=po["vocab"])
        eval_set, lls = synth_eval(task, po["num-utts"],
                                   noise=po["noise"], peak=po["peak"])
        print(json.dumps(run_point(task, eval_set, lls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
