"""Eleventh bank of CLI tools: the fork's flagship batched GPU-pipeline
binary re-expressed in JAX, SGMM2 acc/est split, lattice composition.

Canonical shapes mirrored: cudadecoderbin/batched-wav-nnet3-cuda.cc
(the fork's flagship: whole pipeline wav → features → nnet → WFST
decode → determinized lattices, batched on the accelerator),
sgmm2bin/{sgmm2-acc-stats,sgmm2-sum-accs,sgmm2-est}.cc,
latbin/{lattice-compose,lattice-determinize}.cc, bin/post-to-tacc.cc.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kaldi_tpu.cli.tools import tool
from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.core.table import (RandomAccessTableReader,
                                  SequentialTableReader, TableWriter)

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# cudadecoderbin → the batched JAX pipeline
# ---------------------------------------------------------------------------

def _batched_wav_nnet3(argv):
    """wav → MFCC → TDNN-F scores (one batched forward per bucket) →
    WFST lattice decode → determinized CompactLattices.  The whole
    fork-flagship pipeline in one process, AM scoring batched on the
    chip (BatchedThreadedNnet3CudaPipeline role; lattice passes run in
    the fused native C++ code on the large-graph path)."""
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.cli.tools import _LatgenDecoder, _load_hclg
    from kaldi_tpu.cli.tools_bank3 import _load_tdnn
    from kaldi_tpu.features import (DeltaFeaturesOptions,
                                    FrameExtractionOptions, Mfcc,
                                    MfccOptions)
    from kaldi_tpu.fst.fst import SymbolTable
    po = ParseOptions(
        "batched-wav-nnet3-cuda [opts] <trans-model> <raw-nnet3> <fst> "
        "<wav-rspec> <lattice-wspec> [<words-wspec>]")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("batch-size", int, 16, "utterances per nnet batch")
    po.register("sample-frequency", float, 16000.0, "expected rate")
    po.register("num-ceps", int, 13, "MFCC cepstra (model input dim)")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    if len(args) < 5:
        po.print_usage()
        return 1
    tm, _am = read_mdl(args[0])
    _, fwd = _load_tdnn(args[1], po["frame-subsampling-factor"])
    dec = _LatgenDecoder(_load_hclg(args[2]), tm.tid_to_pdf_array,
                         po["beam"], po["lattice-beam"],
                         po["acoustic-scale"],
                         max_active=po["max-active"])
    mfcc = Mfcc(MfccOptions(
        num_ceps=po["num-ceps"],
        frame_opts=FrameExtractionOptions(
            samp_freq=po["sample-frequency"], dither=0.0)))
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    wwriter = (TableWriter(args[5], holder="text")
               if len(args) > 5 else None)

    # stage 1: features for a batch of wavs; stage 2: ONE padded nnet
    # forward for the batch; stage 3: per-utterance lattice decode
    def flush(batch, lw):
        if not batch:
            return 0
        keys = [k for k, _ in batch]
        feats = [np.asarray(mfcc.compute(w), np.float32)
                 for _, w in batch]
        T_pad = int(np.ceil(max(f.shape[0] for f in feats) / 32) * 32)
        X = np.zeros((len(feats), T_pad, feats[0].shape[1]), np.float32)
        for i, f in enumerate(feats):
            X[i, :f.shape[0]] = f
        scores = np.asarray(fwd(X))            # (B, T', P) one forward
        sub = po["frame-subsampling-factor"]
        for i, key in enumerate(keys):
            Ti = feats[i].shape[0] // sub
            clat = dec.decode_to_clat(scores[i, :max(Ti, 1)])
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w)
                    for w in wseq]
            if wwriter:
                wwriter[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
        return len(batch)

    n = 0
    batch = []
    with TableWriter(args[4], holder="clat") as lw:
        for key, (wave, rate) in SequentialTableReader(args[3],
                                                       holder="wav"):
            if rate != po["sample-frequency"]:
                raise KaldiError(f"{key}: rate {rate} != "
                                 f"{po['sample-frequency']}")
            batch.append((key, np.asarray(wave)))
            if len(batch) >= po["batch-size"]:
                n += flush(batch, lw)
                batch = []
        n += flush(batch, lw)
    if wwriter:
        wwriter.close()
    log.info("batched-wav-nnet3: decoded %d utterances", n)
    return 0


tool("batched-wav-nnet3-cuda")(_batched_wav_nnet3)   # reference name
tool("batched-wav-nnet3")(_batched_wav_nnet3)        # short spelling


# ---------------------------------------------------------------------------
# sgmm2bin: acc / sum / est over serialized models
# ---------------------------------------------------------------------------

@tool("sgmm2-acc-stats")
def sgmm2_acc_stats(argv):
    """Accumulate SGMM2 EM stats against a serialized model
    (sgmm2bin/sgmm2-acc-stats.cc; pdf alignments stand in for
    posteriors)."""
    from kaldi_tpu.am.sgmm2 import accumulate, read_sgmm2
    from kaldi_tpu.core import io as kio
    po = ParseOptions("sgmm2-acc-stats <sgmm2> <feats-rspec> "
                      "<pdf-ali-rspec> <accs-out>")
    args = po.read(argv)
    model = read_sgmm2(args[0])
    alis = RandomAccessTableReader(args[2], holder="ivec")
    tot = None
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in alis:
            continue
        accs = accumulate(model, np.asarray(feats),
                          np.asarray(alis[key], np.int32))
        tot = accs if tot is None else tot + accs
        n += 1
    if tot is None:
        raise KaldiError("sgmm2-acc-stats: no matched utterances")
    _write_sgmm2_accs(args[3], tot)
    log.info("sgmm2-acc-stats: %d utterances, avg loglike %.4f",
             n, tot.tot_like / max(tot.tot_frames, 1.0))
    return 0


def _write_sgmm2_accs(path, tot):
    from kaldi_tpu.am.serialize import write_pytree
    from kaldi_tpu.core import io as kio
    d = {"gamma": tot.gamma, "y": tot.y, "S": tot.S,
         "tot_like": np.float64(tot.tot_like),
         "tot_frames": np.float64(tot.tot_frames)}
    if tot.Z is not None:
        d["Z"] = tot.Z
        d["R"] = tot.R
    if tot.S2 is not None:          # full-covariance scatter
        d["S2"] = tot.S2
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<SGMM2ACCS>")
        write_pytree(f, d)
        kio.write_token(f, "</SGMM2ACCS>")


def _read_sgmm2_accs(path, J):
    from kaldi_tpu.am.serialize import read_pytree
    from kaldi_tpu.am.sgmm2 import Sgmm2Accs
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not binary kaldi")
        kio.expect_token(f, "<SGMM2ACCS>")
        d = read_pytree(f)
        kio.expect_token(f, "</SGMM2ACCS>")
    return Sgmm2Accs(gamma=d["gamma"], y=d["y"], S=d["S"],
                     Z=d.get("Z"), R=d.get("R"), S2=d.get("S2"),
                     tot_like=float(d["tot_like"]),
                     tot_frames=float(d["tot_frames"]))


@tool("sgmm2-sum-accs")
def sgmm2_sum_accs(argv):
    """Sum SGMM2 accumulators (sgmm2bin/sgmm2-sum-accs.cc).  Needs the
    model for the pdf count."""
    from kaldi_tpu.am.sgmm2 import read_sgmm2
    from kaldi_tpu.core import io as kio
    po = ParseOptions("sgmm2-sum-accs <sgmm2> <accs-out> <accs-in1> "
                      "[<accs-in2> ...]")
    args = po.read(argv)
    J = read_sgmm2(args[0]).num_pdfs
    tot = None
    for path in args[2:]:
        a = _read_sgmm2_accs(path, J)
        tot = a if tot is None else tot + a
    _write_sgmm2_accs(args[1], tot)
    return 0


@tool("sgmm2-est-from-accs")
def sgmm2_est_from_accs(argv):
    """M-step: accumulators + model → re-estimated model
    (sgmm2bin/sgmm2-est.cc proper)."""
    from kaldi_tpu.am.sgmm2 import read_sgmm2, update, write_sgmm2
    po = ParseOptions("sgmm2-est-from-accs <sgmm2-in> <accs> "
                      "<sgmm2-out>")
    args = po.read(argv)
    model = read_sgmm2(args[0])
    accs = _read_sgmm2_accs(args[1], model.num_pdfs)
    write_sgmm2(args[2], update(model, accs))
    log.info("sgmm2-est-from-accs: avg loglike %.4f over %.0f frames",
             accs.tot_like / max(accs.tot_frames, 1.0), accs.tot_frames)
    return 0


# ---------------------------------------------------------------------------
# latbin
# ---------------------------------------------------------------------------

@tool("lattice-compose")
def lattice_compose(argv):
    """Compose lattices with a word acceptor FST (biased-LM /
    constraint intersection; latbin/lattice-compose.cc).  The FST must
    be deterministic over word labels; its weights add to graph
    costs."""
    from kaldi_tpu.cli.tools_extra import _load_fst
    from kaldi_tpu.fst.fst import VectorFst
    from kaldi_tpu.lattice.lattice import CompactArc, CompactLattice
    po = ParseOptions("lattice-compose <lattice-rspec> <fst> "
                      "<lattice-wspec>")
    args = po.read(argv)
    fst = _load_fst(args[1])
    # per-state word→(arc) deterministic index
    index = []
    for arcs in fst.arcs:
        d = {}
        for a in arcs:
            if a.olabel in d:
                raise KaldiError("lattice-compose: FST is "
                                 "nondeterministic over words")
            d[a.olabel] = a
        index.append(d)
    n = 0
    with TableWriter(args[2], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            out = CompactLattice()
            smap = {}

            def get(ls, fs):
                if (ls, fs) not in smap:
                    smap[(ls, fs)] = out.add_state()
                return smap[(ls, fs)]

            if clat.start < 0 or fst.start < 0:
                w[key] = out
                continue
            out.start = get(clat.start, fst.start)
            stack = [(clat.start, fst.start)]
            seen = {(clat.start, fst.start)}
            while stack:
                ls, fs = stack.pop()
                cur = get(ls, fs)
                if ls in clat.finals and fs in fst.finals:
                    gc, ac, tids = clat.finals[ls]
                    out.finals[cur] = (gc + fst.finals[fs], ac, tids)
                for a in clat.arcs[ls]:
                    if a.word == 0:
                        nfs = fs
                        extra = 0.0
                    elif a.word in index[fs]:
                        fa = index[fs][a.word]
                        nfs = fa.nextstate
                        extra = fa.weight
                    else:
                        continue
                    out.arcs[cur].append(CompactArc(
                        a.word, a.graph_cost + extra, a.acoustic_cost,
                        a.tids, get(a.nextstate, nfs)))
                    if (a.nextstate, nfs) not in seen:
                        seen.add((a.nextstate, nfs))
                        stack.append((a.nextstate, nfs))
            w[key] = out
            n += 1
    log.info("lattice-compose: %d lattices", n)
    return 0


@tool("lattice-determinize")
def lattice_determinize_tool(argv):
    """(Re-)determinize lattices (latbin/lattice-determinize.cc; the
    pruned variant is lattice-determinize-pruned)."""
    from kaldi_tpu.lattice.determinize import (determinize_lattice,
                                               prune_lattice)
    from kaldi_tpu.lattice.lattice import Lattice, LatticeArc
    po = ParseOptions("lattice-determinize [opts] <lattice-rspec> "
                      "<lattice-wspec>")
    po.register("beam", float, 0.0, "if > 0, prune afterwards")
    args = po.read(argv)
    n = 0
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            # expand CompactLattice → raw Lattice and re-determinize
            lat = Lattice()
            for _ in range(clat.num_states):
                lat.add_state()
            lat.start = clat.start
            extra = []
            for s, arcs in enumerate(clat.arcs):
                for a in arcs:
                    tids = a.tids or (0,)
                    cur = s
                    for i, t in enumerate(tids):
                        last = i == len(tids) - 1
                        dst = a.nextstate if last else lat.add_state()
                        lat.arcs[cur].append(LatticeArc(
                            t, a.word if i == 0 else 0,
                            a.graph_cost if i == 0 else 0.0,
                            a.acoustic_cost if i == 0 else 0.0, dst))
                        cur = dst
            for s, (gc, ac, tids) in clat.finals.items():
                cur = s
                for t in tids:
                    dst = lat.add_state()
                    lat.arcs[cur].append(LatticeArc(t, 0, 0.0, 0.0, dst))
                    cur = dst
                lat.finals[cur] = (gc, ac)
            det = determinize_lattice(lat)
            if po["beam"] > 0:
                det = prune_lattice(det, po["beam"])
            w[key] = det
            n += 1
    log.info("lattice-determinize: %d lattices", n)
    return 0


# ---------------------------------------------------------------------------
# bin
# ---------------------------------------------------------------------------

@tool("post-to-tacc")
def post_to_tacc(argv):
    """Sum posterior weights per transition-id → accumulator vector
    (bin/post-to-tacc.cc; the transition-update stats)."""
    from kaldi_tpu.core import io as kio
    po = ParseOptions("post-to-tacc [--dim=N] <post-rspec> <acc-out>")
    po.register("dim", int, 0, "tid vector size (0 = grow to max)")
    args = po.read(argv)
    acc = np.zeros(max(po["dim"], 1), np.float64)
    for _key, post in SequentialTableReader(args[0], holder="post"):
        for frame in post:
            for tid, wgt in frame:
                if tid >= len(acc):
                    grown = np.zeros(tid + 1, np.float64)
                    grown[:len(acc)] = acc
                    acc = grown
                acc[tid] += wgt
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_vector(f, acc.astype(np.float32))
    log.info("post-to-tacc: %d tids, total %.1f", len(acc), acc.sum())
    return 0
