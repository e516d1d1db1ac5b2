"""Command-line tools mirroring the reference's binary layer (L10).

Each tool follows the canonical reference shape (SURVEY.md §2.1 bins):
ParseOptions + table loop + one library call.  Invoke via

    python -m kaldi_tpu.cli <tool-name> [options] args...

Tool names keep the Kaldi spelling so recipe translations are 1:1.
"""

from __future__ import annotations

import struct
import sys
from typing import Callable, Dict, List

import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.core.table import (
    RandomAccessTableReader,
    SequentialTableReader,
    TableWriter,
)

log = get_logger(__name__)

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn
    return deco


def _frame_opts_po(po: ParseOptions) -> None:
    po.register("sample-frequency", float, 16000.0, "sample rate")
    po.register("frame-length", float, 25.0, "frame length ms")
    po.register("frame-shift", float, 10.0, "frame shift ms")
    po.register("dither", float, 1.0, "dither")
    po.register("window-type", str, "povey", "window type")
    po.register("num-mel-bins", int, 23, "mel bins")


def _make_frame_opts(po):
    from kaldi_tpu.features import FrameExtractionOptions
    return FrameExtractionOptions(
        samp_freq=po["sample-frequency"], frame_length_ms=po["frame-length"],
        frame_shift_ms=po["frame-shift"], dither=po["dither"],
        window_type=po["window-type"])


def _feature_tool(argv, computer_factory, usage, extra=None):
    po = ParseOptions(usage)
    _frame_opts_po(po)
    if extra is not None:
        extra(po)
    args = po.read(argv)
    if len(args) != 2:
        po.print_usage()
        return 1
    computer = computer_factory(po)
    n = 0
    with TableWriter(args[1], holder="mat") as w:
        for key, (wave, rate) in SequentialTableReader(args[0], holder="wav"):
            if rate != po["sample-frequency"]:
                raise KaldiError(f"{key}: sample rate {rate} != "
                                 f"{po['sample-frequency']}")
            w[key] = computer.compute(wave)
            n += 1
    log.info("processed %d utterances", n)
    return 0


@tool("compute-mfcc-feats")
def compute_mfcc_feats(argv):
    from kaldi_tpu.features import MelBanksOptions, Mfcc, MfccOptions

    def factory(po):
        return Mfcc(MfccOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"]),
            num_ceps=po["num-ceps"]))

    return _feature_tool(
        argv, factory,
        "compute-mfcc-feats [opts] <wav-rspecifier> <feats-wspecifier>",
        extra=lambda po: po.register("num-ceps", int, 13,
                                     "number of cepstra"))


@tool("compute-fbank-feats")
def compute_fbank_feats(argv):
    from kaldi_tpu.features import Fbank, FbankOptions, MelBanksOptions

    def factory(po):
        return Fbank(FbankOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"])))

    return _feature_tool(
        argv, factory,
        "compute-fbank-feats [opts] <wav-rspecifier> <feats-wspecifier>")


@tool("compute-plp-feats")
def compute_plp_feats(argv):
    from kaldi_tpu.features import MelBanksOptions, Plp, PlpOptions

    def factory(po):
        return Plp(PlpOptions(
            frame_opts=_make_frame_opts(po),
            mel_opts=MelBanksOptions(num_bins=po["num-mel-bins"])))

    return _feature_tool(
        argv, factory,
        "compute-plp-feats [opts] <wav-rspecifier> <feats-wspecifier>")


@tool("copy-feats")
def copy_feats(argv):
    po = ParseOptions("copy-feats <rspecifier> <wspecifier>")
    po.register("compress", bool, False,
                "write compressed (\"CM\") matrices")
    args = po.read(argv)
    holder = "cmat" if po["compress"] else "mat"
    with TableWriter(args[1], holder=holder) as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = mat
    return 0


@tool("compute-cmvn-stats")
def compute_cmvn_stats_tool(argv):
    from kaldi_tpu.features import compute_cmvn_stats, sum_cmvn_stats
    po = ParseOptions(
        "compute-cmvn-stats [--spk2utt=...] <feats-rspec> <stats-wspec>")
    po.register("spk2utt", str, "", "spk2utt file for per-speaker stats")
    args = po.read(argv)
    feats = RandomAccessTableReader(args[0], holder="mat")
    with TableWriter(args[1], holder="mat") as w:
        if po["spk2utt"]:
            with open(po["spk2utt"]) as f:
                for line in f:
                    parts = line.split()
                    spk, utts = parts[0], parts[1:]
                    stats = sum_cmvn_stats(
                        [compute_cmvn_stats(feats[u]) for u in utts
                         if u in feats])
                    w[spk] = stats
        else:
            for key in feats.keys():
                w[key] = compute_cmvn_stats(feats[key])
    return 0


@tool("apply-cmvn")
def apply_cmvn_tool(argv):
    from kaldi_tpu.features import apply_cmvn
    po = ParseOptions(
        "apply-cmvn [--utt2spk=...] <stats-rspec> <feats-rspec> <out-wspec>")
    po.register("norm-vars", bool, False, "normalize variance")
    po.register("utt2spk", str, "", "utt2spk map file")
    args = po.read(argv)
    stats = RandomAccessTableReader(args[0], holder="mat")
    u2s = {}
    if po["utt2spk"]:
        with open(po["utt2spk"]) as f:
            u2s = dict(line.split()[:2] for line in f if line.strip())
    with TableWriter(args[2], holder="mat") as w:
        for key, mat in SequentialTableReader(args[1], holder="mat"):
            skey = u2s.get(key, key)
            w[key] = np.asarray(apply_cmvn(mat, stats[skey],
                                           norm_vars=po["norm-vars"]))
    return 0


@tool("add-deltas")
def add_deltas_tool(argv):
    from kaldi_tpu.features import DeltaFeaturesOptions, add_deltas
    po = ParseOptions("add-deltas <rspecifier> <wspecifier>")
    po.register("delta-order", int, 2, "delta order")
    po.register("delta-window", int, 2, "delta window")
    args = po.read(argv)
    opts = DeltaFeaturesOptions(order=po["delta-order"],
                                window=po["delta-window"])
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = np.asarray(add_deltas(np.asarray(mat), opts))
    return 0


@tool("splice-feats")
def splice_feats_tool(argv):
    from kaldi_tpu.features import splice_frames
    po = ParseOptions("splice-feats <rspecifier> <wspecifier>")
    po.register("left-context", int, 4, "left context")
    po.register("right-context", int, 4, "right context")
    args = po.read(argv)
    with TableWriter(args[1], holder="mat") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = np.asarray(splice_frames(np.asarray(mat),
                                              po["left-context"],
                                              po["right-context"]))
    return 0


@tool("transform-feats")
def transform_feats_tool(argv):
    from kaldi_tpu.am.transforms import apply_transform
    po = ParseOptions("transform-feats <matrix-file> <rspec> <wspec>")
    args = po.read(argv)
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        mat = kio.read_matrix(f)
    with TableWriter(args[2], holder="mat") as w:
        for key, feats in SequentialTableReader(args[1], holder="mat"):
            w[key] = apply_transform(np.asarray(feats), mat)
    return 0


@tool("compute-wer")
def compute_wer_tool(argv):
    from kaldi_tpu.pipelines.score import compute_wer
    po = ParseOptions("compute-wer <ref-rspecifier> <hyp-rspecifier>")
    args = po.read(argv)
    refs = dict(SequentialTableReader(args[0], holder="text"))
    hyps = dict(SequentialTableReader(args[1], holder="text"))
    stats = compute_wer(refs, hyps)
    print(stats)
    return 0


@tool("gmm-info")
def gmm_info(argv):
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions("gmm-info <model-file>")
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    print(f"number of phones {len(tm.topo.phones)}")
    print(f"number of pdfs {am.num_pdfs}")
    print(f"number of transition-ids {tm.num_transition_ids}")
    print(f"number of transition-states {len(tm.tuples)}")
    print(f"feature dimension {am.dim}")
    print(f"number of gaussians {am.num_gauss()}")
    return 0


def _load_hclg(path: str):
    """Text or binary OpenFst vector/const file → VectorFst."""
    from kaldi_tpu.fst.fst import VectorFst
    with open(path, "rb") as fh:
        is_binary = fh.read(4) == struct.pack("<i", 2125659606)
    if is_binary:
        from kaldi_tpu.fst.openfst_io import read_fst_path
        return read_fst_path(path)
    return VectorFst.read_text(path)


def register_latgen_opts(po) -> None:
    """Register the BeamDecoder budget/escalation knobs on a latgen
    tool's ParseOptions (the LatticeFasterDecoderConfig::Register
    role for this decoder's own controls: the CLI exposes the arc
    budget and the quality safety net)."""
    po.register("arc-budget", int, 4096,
                "device arcs expanded per frame (0 = auto-wide)")
    po.register("escalate-budget", int, 16384,
                "re-decode budget for utterances the arc budget "
                "over-pruned (0 disables escalation)")
    po.register("escalate-deficit", float, 4.0,
                "escalation trigger: accumulated beam deficit "
                "(sum over frames of lattice-beam shortfall)")
    po.register("arc-block", int, 8, "arcs fetched per gather row")


def latgen_kwargs(po) -> dict:
    """po → _LatgenDecoder keyword overrides (after
    register_latgen_opts)."""
    return dict(arc_budget=po["arc-budget"],
                escalate_budget=po["escalate-budget"],
                escalate_deficit=po["escalate-deficit"],
                arc_block=po["arc-block"])


class _LatgenDecoder:
    """Decoder dispatch for the latgen tools: DenseDecoder (gather
    Viterbi) for small graphs, BeamDecoder (the large-vocab sort
    decoder with fused native lattice build + determinize) above
    `dense_limit` states — the LatticeFasterDecoder operating point
    scales to real HCLGs either way.

    Defaults are QUALITY-SAFE: the arc budget runs at the fast
    operating point (4096) with demand-triggered escalation to 16384
    — the budget alone loses oracle WER on hard
    corpora; the escalation policy (decoder/beam.py
    BeamDecoderConfig.escalate_budget) closes that at defaults."""

    def __init__(self, HCLG, tid_to_pdf, beam, lattice_beam,
                 acoustic_scale, max_active=7000, dense_limit=20000,
                 arc_budget=4096, escalate_budget=16384,
                 escalate_deficit=4.0, arc_block=8):
        if HCLG.num_states > dense_limit:
            from kaldi_tpu.decoder.beam import (BeamDecoder,
                                                BeamDecoderConfig)
            from kaldi_tpu.fst.csr import pack_fst
            cap = max(max_active, 512)
            self._dec = BeamDecoder(pack_fst(HCLG), tid_to_pdf,
                                    BeamDecoderConfig(
                beam=beam, lattice_beam=lattice_beam,
                acoustic_scale=acoustic_scale, max_active=max_active,
                arc_budget=arc_budget, arc_block=arc_block,
                escalate_budget=escalate_budget,
                escalate_deficit=escalate_deficit,
                lattice_arcs_per_frame=max(2 * cap, 4096)))
            self._compact = True
            log.info("latgen: %d states → BeamDecoder (large-graph "
                     "path; arc_budget %d, escalate %d)",
                     HCLG.num_states, arc_budget, escalate_budget)
        else:
            from kaldi_tpu.decoder.dense import (DenseDecoder,
                                                 DenseDecoderConfig)
            self._dec = DenseDecoder(HCLG, tid_to_pdf, DenseDecoderConfig(
                beam=beam, lattice_beam=lattice_beam,
                acoustic_scale=acoustic_scale))
            self._compact = False

    def decode_to_clat(self, loglikes: np.ndarray):
        if self._compact:
            return self._dec.decode_compact(loglikes)
        from kaldi_tpu.lattice.determinize import \
            determinize_lattice_pruned
        lat, _best = self._dec.decode_lattice(loglikes)
        # blowup → prune with halved beams and retry (the
        # DeterminizeLatticePhonePrunedWrapper contract)
        return determinize_lattice_pruned(
            lat, self._dec.config.lattice_beam)


@tool("gmm-latgen-faster")
def gmm_latgen_faster(argv):
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions(
        "gmm-latgen-faster [opts] <model> <fst> <feats-rspec> "
        "<lattice-wspec> [<words-wspec>]\n"
        "<fst> may be a text FST or a binary OpenFst vector/const file")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt for text output")
    register_latgen_opts(po)
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    HCLG = _load_hclg(args[1])
    dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                         po["lattice-beam"], po["acoustic-scale"],
                         max_active=po["max-active"],
                         **latgen_kwargs(po))
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    wwriter = (TableWriter(args[4], holder="text")
               if len(args) > 4 else None)
    n, tot_frames = 0, 0
    with TableWriter(args[3], holder="clat") as lw:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            ll = np.asarray(am.loglikes(np.asarray(feats)))
            clat = dec.decode_to_clat(ll)
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w) for w in wseq]
            if wwriter:
                wwriter[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
            tot_frames += ll.shape[0]
    if wwriter:
        wwriter.close()
    log.info("decoded %d utterances, %d frames", n, tot_frames)
    return 0


@tool("lattice-best-path")
def lattice_best_path(argv):
    po = ParseOptions(
        "lattice-best-path [opts] <lattice-rspec> <words-wspec>")
    po.register("lm-scale", float, 1.0, "LM scale")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    from kaldi_tpu.lattice import scale_lattice
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    with TableWriter(args[1], holder="text") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            scale_lattice(clat, po["lm-scale"], po["acoustic-scale"])
            wseq, _, cost = clat.best_path()
            w[key] = [words_tab.find(x) if words_tab else str(x)
                      for x in wseq]
    return 0


@tool("lattice-to-nbest")
def lattice_to_nbest(argv):
    """N best paths as single-path CompactLattices keyed utt-1..utt-N
    (latbin/lattice-to-nbest.cc; feed to nbest-to-linear)."""
    from kaldi_tpu.lattice.functions import nbest_paths, path_to_lattice
    po = ParseOptions("lattice-to-nbest [--n=10] <lattice-rspec> <wspec>")
    po.register("n", int, 10, "number of paths")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            for i, (arcs, fin, _cost) in enumerate(
                    nbest_paths(clat, po["n"])):
                w[f"{key}-{i + 1}"] = path_to_lattice(arcs, fin)
    return 0


@tool("lattice-mbr-decode")
def lattice_mbr_decode(argv):
    from kaldi_tpu.lattice import mbr_decode
    po = ParseOptions("lattice-mbr-decode <lattice-rspec> <words-wspec>")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    words_tab = None
    if po["word-symbol-table"]:
        from kaldi_tpu.fst.fst import SymbolTable
        words_tab = SymbolTable.read(po["word-symbol-table"])
    with TableWriter(args[1], holder="text") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            r = mbr_decode(clat)
            w[key] = [words_tab.find(x) if words_tab else str(x)
                      for x in r.words]
    return 0


@tool("lattice-scale")
def lattice_scale_tool(argv):
    from kaldi_tpu.lattice import scale_lattice
    po = ParseOptions("lattice-scale <rspec> <wspec>")
    po.register("lm-scale", float, 1.0, "")
    po.register("acoustic-scale", float, 1.0, "")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = scale_lattice(clat, po["lm-scale"], po["acoustic-scale"])
    return 0


@tool("lattice-prune")
def lattice_prune_tool(argv):
    from kaldi_tpu.lattice import prune_lattice
    po = ParseOptions("lattice-prune --beam=4.0 <rspec> <wspec>")
    po.register("beam", float, 4.0, "pruning beam")
    args = po.read(argv)
    with TableWriter(args[1], holder="clat") as w:
        for key, clat in SequentialTableReader(args[0], holder="clat"):
            w[key] = prune_lattice(clat, po["beam"])
    return 0


@tool("ali-to-phones")
def ali_to_phones(argv):
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions("ali-to-phones <model> <ali-rspec> <phones-wspec>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0])
    with TableWriter(args[2], holder="ivec") as w:
        for key, ali in SequentialTableReader(args[1], holder="ivec"):
            w[key] = np.asarray(tm.alignment_to_phones(ali.tolist()),
                                dtype=np.int32)
    return 0


@tool("ali-to-pdf")
def ali_to_pdf(argv):
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions("ali-to-pdf <model> <ali-rspec> <pdf-wspec>")
    args = po.read(argv)
    tm, _ = read_mdl(args[0])
    with TableWriter(args[2], holder="ivec") as w:
        for key, ali in SequentialTableReader(args[1], holder="ivec"):
            w[key] = tm.tid_to_pdf_array[np.asarray(ali)]
    return 0


@tool("lattice-to-ctm")
def lattice_to_ctm(argv):
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.lattice.ctm import best_path_ctm
    from kaldi_tpu.fst.fst import SymbolTable
    po = ParseOptions(
        "lattice-to-ctm <model> <words.txt> <lattice-rspec> [<ctm-file>]")
    po.register("frame-shift", float, 0.01, "frame shift seconds")
    po.register("silence-phones", str, "1", "colon-separated silence ids")
    po.register("lexicon", str, "", "lexicon text file (word phone...) "
                "with phones.txt beside it, for exact word alignment")
    po.register("phone-symbol-table", str, "", "phones.txt (with --lexicon)")
    args = po.read(argv)
    tm, _ = read_mdl(args[0])
    words = SymbolTable.read(args[1])
    sil = {int(x) for x in po["silence-phones"].split(":") if x}
    prons = None
    if po["lexicon"]:
        phones = SymbolTable.read(po["phone-symbol-table"])
        prons = {}
        with open(po["lexicon"]) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2 and parts[0] in words:
                    prons.setdefault(words[parts[0]], []).append(
                        [phones[p] for p in parts[1:]])
    out = open(args[3], "w") if len(args) > 3 else sys.stdout
    for key, clat in SequentialTableReader(args[2], holder="clat"):
        for entry in best_path_ctm(clat, tm, words, key, sil,
                                   po["frame-shift"], prons=prons):
            print(entry, file=out)
    if len(args) > 3:
        out.close()
    return 0


@tool("compute-vad")
def compute_vad_tool(argv):
    from kaldi_tpu.am.ivector import VadEnergyOptions, compute_vad_energy
    po = ParseOptions("compute-vad <feats-rspec> <vad-wspec>")
    po.register("vad-energy-threshold", float, 5.0, "")
    po.register("vad-energy-mean-scale", float, 0.5, "")
    args = po.read(argv)
    opts = VadEnergyOptions(po["vad-energy-threshold"],
                            po["vad-energy-mean-scale"])
    with TableWriter(args[1], holder="vec") as w:
        for key, mat in SequentialTableReader(args[0], holder="mat"):
            w[key] = compute_vad_energy(mat, opts)
    return 0


@tool("resample-wav")
def resample_wav(argv):
    from kaldi_tpu.features.resample import linear_resample
    po = ParseOptions("resample-wav --target-rate=8000 <wav-rspec> <wspec>")
    po.register("target-rate", float, 16000.0, "output sample rate")
    args = po.read(argv)
    with TableWriter(args[1], holder="wav") as w:
        for key, (wave, rate) in SequentialTableReader(args[0], holder="wav"):
            out = linear_resample(wave / 32768.0, rate, po["target-rate"])
            w[key] = (out, int(po["target-rate"]))
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("Available tools:", file=sys.stderr)
        for name in sorted(TOOLS):
            print(f"  {name}", file=sys.stderr)
        return 1
    name, rest = argv[0], argv[1:]
    if name not in TOOLS:
        print(f"Unknown tool '{name}'. Run with --help for the list.",
              file=sys.stderr)
        return 1
    try:
        return TOOLS[name](rest) or 0
    except KaldiError as e:
        print(f"ERROR ({name}): {e}", file=sys.stderr)
        return 1
