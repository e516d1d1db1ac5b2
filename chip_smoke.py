#!/usr/bin/env python3
"""Smoke run of the main path on the GPU, through the user entry points.

    python chip_smoke.py          # one card: device, decode, stream,
                                  # train, served
    python chip_smoke.py --four   # four cards: sharded decode and
                                  # sharded chain training, nothing else

Phases (one process; random weights and data made from fixed seeds):

  device  the card, its power limit, versions, the compile cache and
          the native lattice library (required).
  decode  the 20k-word pruned-trigram HCLG (~176k states), BeamDecoder
          at beam 13 / max-active 7000 / lattice-beam 7 with escalation,
          96 synthetic utterances in batches of 32, both device β-prune
          modes, lattices determinized to CompactLattice.  WER must be
          0.00 on this corpus, both β modes must agree, and 8 utterances
          must decode identically on the CPU backend.
  stream  OnlineBeamDecoder (6-frame chunks) must finalize to the
          offline best paths; MultiStreamBeamDecoder runs 8 lanes for
          30 chunks and each lane finalizes to its offline best path.
  train   ChainTrainer with NG-SGD on a 41-phone trigram den graph,
          TDNN-F 13 × 1024 (bottleneck 128) on 128 × 150-frame egs, 5
          steps in float32 and 5 in bfloat16; the forward pass and the
          den log-partition are checked against float64 NumPy.
  served  synthesized audio → fbank (40 bins) → TDNN-F → BeamDecoder on
          the 20k graph, all on the card.
  four    (--four) ShardedBeamDecoder over 4 cards against the one-card
          decode, and ChainTrainer steps at data=4 and at data=2 ×
          model=2 against the one-card steps.

Each phase prints one line with its wall time, its compile time (the
JAX trace + lowering + backend compile durations inside the phase,
reported separately) and its checks.  Any failed check raises and the
script exits nonzero; without a GPU it exits nonzero before any phase.
The last line of standard output is the JSON result.  Numbers printed
here are a smoke reading, not a benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# --- tolerances, each with its reason ---------------------------------------
# Decode best cost, card vs CPU backend and sharded vs one card: the
# same f32 program summed in another order.  The acoustic term is a
# masked sum, not a matrix product, so TF32 does not enter.
DECODE_COST_RTOL = 1e-3
# TDNN-F forward vs float64 NumPy (relative to the output's max |value|):
# - matmul precision "highest": true f32 products, f32 rounding only;
FWD_RTOL_HIGHEST = 1e-4
# - default precision: f32 matmuls may run in TF32 (10-bit mantissa);
FWD_RTOL_DEFAULT = 2e-2
# - bfloat16 compute (8-bit mantissa operands, f32 batch norm).
FWD_RTOL_BF16 = 5e-2
# Den-graph log-partition vs float64 NumPy: the dense recursion asks for
# Precision.HIGHEST, so only f32 accumulation over the frames remains.
DEN_RTOL = 1e-5
# One chain step's loss, sharded vs one card (float32 model): the batch
# norm moments, the loss reduction and the row-parallel partial sums are
# summed in another order per sharding.
SHARDED_LOSS_RTOL = 1e-4

FRAME_S = 0.03          # decoded frames are ×3-subsampled 10 ms frames


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The smoke's operating point (defaults: the bench's full size)."""
    vocab: int = 20000
    n_utts: int = 96
    batch: int = 32
    n_cpu: int = 8
    n_stream: int = 12
    n_lanes: int = 8
    lane_chunks: int = 30
    stream_max_frames: int = 1024
    lane_max_frames: int = 512
    hidden: int = 1024
    bottleneck: int = 128
    layers: int = 13
    egs: int = 128
    egs_frames: int = 150
    steps: int = 5
    n_fwd: int = 4
    n_served: int = 8
    n_four: int = 32


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# --- compile-time accounting --------------------------------------------------

_COMPILE_S = [0.0]
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
                   "/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


def _count_compile(event, duration, **_):
    if event in _COMPILE_EVENTS:
        _COMPILE_S[0] += duration


class Phase:
    """Times one phase and prints its line; never catches a failure."""

    def __init__(self, name: str):
        self.name = name
        self.checks = {}

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = _COMPILE_S[0]
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        wall = time.perf_counter() - self.t0
        comp = _COMPILE_S[0] - self.c0
        items = " ".join(f"{k}={v}" for k, v in self.checks.items())
        print(f"phase={self.name} wall_s={wall:.1f} compile_s={comp:.1f} "
              f"{items}", flush=True)
        return False


# --- gate ---------------------------------------------------------------------

def require_gpu(count: int = 1):
    """The GPU devices, or exit nonzero: there is no CPU fallback."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX's default platform is "
                 f"{devs[0].platform!r}")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, found {len(devs)}")
    return devs


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return " | ".join(l.strip() for l in r.stdout.splitlines() if l.strip())


def phase_device(devs) -> None:
    import os
    import jax
    import jaxlib
    from kaldi_tpu import native
    from kaldi_tpu.core import jit_cache
    with Phase("device") as ph:
        loaded, why = native.status()
        print(f"device: kind={devs[0].device_kind!r} count={len(devs)} "
              f"nvidia-smi={nvidia_smi()!r} jax={jax.__version__} "
              f"jaxlib={jaxlib.__version__} "
              f"XLA_FLAGS={os.environ.get('XLA_FLAGS')!r} "
              f"compile_cache={jit_cache.enable()!r} native={loaded}",
              flush=True)
        check(loaded, f"native lattice library did not load: {why}")
        ph.checks["native"] = "loaded"


# --- shared setup -------------------------------------------------------------

def decoder_config():
    """bench.py's operating point (the reference's beam 13 /
    max-active 7000 / lattice-beam 7, with demand escalation)."""
    from kaldi_tpu.decoder.beam import BeamDecoderConfig
    return BeamDecoderConfig(beam=13.0, max_active=7000,
                             acoustic_scale=1.0, lattice_beam=7.0,
                             arc_budget=4096, token_capacity=2048,
                             arc_block=8, escalate_budget=16384,
                             escalate_deficit=4.0,
                             lattice_arcs_per_frame=4096,
                             record_capacity=16384)


def build_task(sz: Sizes):
    from kaldi_tpu.pipelines.largevocab import (make_largevocab_task,
                                                sample_eval_set,
                                                synth_loglikes)
    t0 = time.perf_counter()
    task = make_largevocab_task(vocab_size=sz.vocab, order=3, seed=7,
                                closure=False)
    build_s = time.perf_counter() - t0
    eval_set = sample_eval_set(task, sz.n_utts, max_words=6, seed=99)
    rng = np.random.default_rng(1234)
    utts = sorted(eval_set)
    lls = [synth_loglikes(task, eval_set[u], rng, noise=0.5)
           for u in utts]
    order = np.argsort([len(x) for x in lls], kind="stable")
    utts = [utts[i] for i in order]
    lls = [lls[i] for i in order]
    return task, eval_set, utts, lls, build_s


def pad_batch(lls, T_pad: int, P: int, B: int = None):
    B = B or len(lls)
    X = np.zeros((B, T_pad, P), np.float32)
    lens = np.ones(B, np.int32)
    for b, ll in enumerate(lls):
        X[b, :len(ll)] = ll
        lens[b] = len(ll)
    return X, lens


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def best(lat):
    words, _tids, cost = lat.best_path()
    return list(words), float(cost)


def same_path(a, b) -> bool:
    return a[0] == b[0] and abs(a[1] - b[1]) <= DECODE_COST_RTOL * max(
        1.0, abs(a[1]))


def chain_setup(sz: Sizes, dtype: str = "float32"):
    """bench.py's den graph (41 phones, trigram phone LM) and the
    TDNN-F at the recipe's widths."""
    from kaldi_tpu.am.chain import make_denominator_graph
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    phones = list(range(1, 42))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    rng = np.random.default_rng(0)
    seqs = [list(rng.integers(1, 42, 20)) for _ in range(200)]
    den = make_denominator_graph(seqs, tree, topo, order=3)
    ccfg = TdnnConfig(feat_dim=40, num_pdfs=tree.num_pdfs,
                      hidden_dim=sz.hidden, bottleneck_dim=sz.bottleneck,
                      num_layers=sz.layers, frame_subsampling_factor=3,
                      compute_dtype=dtype)
    return den, ccfg, tree


def chain_egs(sz: Sizes, num_pdfs: int, seed: int = 1):
    from kaldi_tpu.pipelines.chain import ChainEgs
    rng = np.random.default_rng(seed)
    N, T = sz.egs, sz.egs_frames
    return ChainEgs(
        rng.standard_normal((N, T, 40)).astype(np.float32),
        rng.integers(0, num_pdfs, (N, T // 3)).astype(np.int32),
        np.ones((N, T // 3), bool))


# --- phases -------------------------------------------------------------------

def phase_decode(sz: Sizes, cpu):
    """→ (task, dec, utts, lls, T_pad, offline best paths by utt)."""
    import jax
    from kaldi_tpu.core.profiling import profile
    from kaldi_tpu.decoder.beam import BeamDecoder
    from kaldi_tpu.pipelines.score import compute_wer
    with Phase("decode") as ph:
        task, eval_set, utts, lls, build_s = build_task(sz)
        ph.checks["graph_build_s"] = f"{build_s:.1f}"
        ph.checks["graph"] = (f"{task.graph.csr.num_states}st/"
                              f"{task.graph.csr.num_emitting_arcs}"
                              f"+{task.graph.csr.num_eps_arcs}arcs")
        tid2pdf = task.tm.tid_to_pdf_array
        dec = BeamDecoder(task.graph.csr, tid2pdf, decoder_config())
        P = task.num_pdfs
        # one padded length for every batch: one executable per β mode
        T_pad = round_up(max(len(x) for x in lls), 32)
        batches = [pad_batch(lls[i:i + sz.batch], T_pad, P)
                   for i in range(0, len(lls), sz.batch)]
        audio_s = sum(len(x) for x in lls) * FRAME_S
        pool = ThreadPoolExecutor(8)
        paths = {}
        for beta in (True, False):
            d = dec if beta else dec.with_overrides(device_beta_prune=False)
            stats = {}
            lats = []
            for X, lens in batches:             # cold: compiles
                lats += d.decode_compact_batch(X, lens, pool=pool,
                                               stats=stats)
            t0 = time.perf_counter()
            for X, lens in batches:             # warm: the smoke reading
                d.decode_compact_batch(X, lens, pool=pool)
            warm = time.perf_counter() - t0
            hyps = {u: [task.words.find(o) for o in lat.best_path()[0]]
                    for u, lat in zip(utts, lats)}
            wer = compute_wer(eval_set, hyps)
            tag = "beta_on" if beta else "beta_off"
            ph.checks[f"{tag}_wer"] = f"{wer.wer:.2f}"
            ph.checks[f"{tag}_audio_s_per_s"] = f"{audio_s / warm:.1f}"
            ph.checks[f"{tag}_n_escalated"] = stats["n_escalated"]
            ph.checks[f"{tag}_dropped_arcs"] = stats["dropped_arcs"]
            ph.checks[f"{tag}_min_eff_beam"] = \
                f"{stats['min_eff_beam']:.3f}"
            check(wer.errors == 0, f"decode {tag}: WER {wer.wer:.2f} "
                  f"({wer.errors} errors) on the WER-0 corpus")
            paths[beta] = {u: best(l) for u, l in zip(utts, lats)}
            if beta:
                gpu_lats = dict(zip(utts, lats))
        check(all(same_path(paths[True][u], paths[False][u])
                  for u in utts), "decode: β modes disagree on best paths")
        ph.checks["beta_modes_agree"] = True

        # the same decoder on the CPU backend for a spread of utterances
        pick = [utts[i] for i in np.linspace(0, len(utts) - 1, sz.n_cpu)
                .astype(int)]
        sub = [lls[utts.index(u)] for u in pick]
        Xc, lc = pad_batch(sub, round_up(max(len(x) for x in sub), 32), P)
        with jax.default_device(cpu):
            dec_cpu = BeamDecoder(task.graph.csr, tid2pdf, decoder_config())
            cpu_lats = dec_cpu.decode_compact_batch(Xc, lc, pool=pool)
        for u, cl in zip(pick, cpu_lats):
            check(same_path(paths[True][u], best(cl)),
                  f"decode: {u} differs from the CPU backend: "
                  f"{paths[True][u]} vs {best(cl)}")
        ph.checks["cpu_agree"] = f"{len(pick)}/{len(pick)}"
        ph.checks["lattice_arcs_gpu"] = sum(gpu_lats[u].num_arcs
                                            for u in pick)
        ph.checks["lattice_arcs_cpu"] = sum(l.num_arcs for l in cpu_lats)

        # device op profile of one batch
        X, lens = batches[-1]
        with profile() as get:
            dec.decode_compact_batch(X, lens, pool=pool)
        top = get().ops()[:10]
        print("decode top device ops (ms, count): " + "; ".join(
            f"{name[:48]} {ms:.3f} x{cnt}" for name, ms, cnt in top),
            flush=True)
        # (a CPU-backend trace has no device plane)
        check(top or jax.devices()[0].platform == "cpu",
              "decode: the profiler found no device ops")
        pool.shutdown()
    return task, dec, utts, lls, T_pad, paths[True]


def phase_stream(sz: Sizes, dec, utts, lls, offline) -> None:
    from kaldi_tpu.decoder.online_beam import (MultiStreamBeamDecoder,
                                               OnlineBeamDecoder)
    C = 6
    with Phase("stream") as ph:
        ob = OnlineBeamDecoder(dec, chunk_frames=C,
                               max_frames=sz.stream_max_frames)
        chunk_ms = []
        for u, ll in list(zip(utts, lls))[:sz.n_stream]:
            ob.reset()
            for a in range(0, len(ll), C):
                t0 = time.perf_counter()
                ob.advance(ll[a:a + C])
                chunk_ms.append(1e3 * (time.perf_counter() - t0))
            got = best(ob.finalize())
            check(same_path(offline[u], got),
                  f"stream: {u} finalized to {got}, offline "
                  f"{offline[u]}")
        ph.checks["online_agree"] = f"{sz.n_stream}/{sz.n_stream}"
        ph.checks["advance_ms_p50"] = f"{np.percentile(chunk_ms, 50):.2f}"

        limit = sz.lane_chunks * C
        lane = [(u, ll) for u, ll in zip(utts, lls) if len(ll) <= limit]
        lane = lane[:sz.n_lanes]
        check(len(lane) == sz.n_lanes, "stream: too few short utterances")
        ms = MultiStreamBeamDecoder(dec, n_channels=sz.n_lanes,
                                    chunk_frames=C,
                                    max_frames=sz.lane_max_frames)
        for k in range(sz.lane_chunks):
            a = k * C
            ms.advance([ll[a:a + C] if a < len(ll) else None
                        for _, ll in lane])
        for c, (u, _) in enumerate(lane):
            got = best(ms.finalize_channel(c))
            check(same_path(offline[u], got),
                  f"stream: lane {c} ({u}) finalized to {got}, offline "
                  f"{offline[u]}")
        ph.checks["lanes_agree"] = f"{sz.n_lanes}/{sz.n_lanes}"
        ph.checks["lane_chunks"] = sz.lane_chunks


def tdnn_forward_errors(sz: Sizes, ccfg):
    """Relative max error of the TDNN-F forward against float64 NumPy
    at three precisions."""
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.am.tdnn import TdnnChain, forward_numpy
    rng = np.random.default_rng(5)
    x = rng.standard_normal((sz.n_fwd, sz.egs_frames, 40)).astype(
        np.float32)
    model = TdnnChain(ccfg)
    v = model.init(jax.random.PRNGKey(3), x)
    # output_affine starts at zero; a zero layer would pass trivially
    k = v["params"]["output_affine"]["kernel"]
    v["params"]["output_affine"]["kernel"] = jnp.asarray(
        rng.standard_normal(k.shape) / np.sqrt(k.shape[0]), jnp.float32)
    ref, _ = forward_numpy(ccfg, v, x)
    scale = np.abs(ref).max()
    check(scale > 0, "train: reference forward is all zero")

    def err(m):
        out = np.asarray(jax.jit(lambda vv, xx: m.apply(vv, xx))(v, x),
                         np.float64)
        check(np.isfinite(out).all(), "train: non-finite forward")
        return float(np.abs(out - ref).max() / scale)

    with jax.default_matmul_precision("highest"):
        e_hi = err(model)
    e_def = err(model)
    e_bf16 = err(TdnnChain(dataclasses.replace(ccfg,
                                               compute_dtype="bfloat16")))
    return e_hi, e_def, e_bf16


def phase_train(sz: Sizes) -> None:
    import jax.numpy as jnp
    from kaldi_tpu.am.chain import denominator_logprob, numpy_den_forward
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    with Phase("train") as ph:
        den, ccfg, tree = chain_setup(sz)
        ph.checks["den_states"] = den.num_states
        e_hi, e_def, e_bf16 = tdnn_forward_errors(sz, ccfg)
        ph.checks["fwd_rel_err_highest"] = f"{e_hi:.2e}"
        ph.checks["fwd_rel_err_default"] = f"{e_def:.2e}"
        ph.checks["fwd_rel_err_bf16"] = f"{e_bf16:.2e}"
        check(e_hi <= FWD_RTOL_HIGHEST, f"train: f32 forward {e_hi:.2e}")
        check(e_def <= FWD_RTOL_DEFAULT, f"train: TF32 forward {e_def:.2e}")
        check(e_bf16 <= FWD_RTOL_BF16, f"train: bf16 forward {e_bf16:.2e}")

        rng = np.random.default_rng(9)
        sc = rng.standard_normal((1, sz.egs_frames // 3,
                                  tree.num_pdfs)).astype(np.float32)
        got = float(denominator_logprob(den, jnp.asarray(sc))[0])
        ref = float(numpy_den_forward(den, sc)[0])
        den_err = abs(got - ref) / max(abs(ref), 1.0)
        ph.checks["den_rel_err"] = f"{den_err:.2e}"
        check(den_err <= DEN_RTOL, f"train: den logZ {got} vs {ref}")

        egs = chain_egs(sz, tree.num_pdfs)
        frames = egs.feats.shape[0] * egs.feats.shape[1]
        for dtype in ("float32", "bfloat16"):
            trainer = ChainTrainer(
                dataclasses.replace(ccfg, compute_dtype=dtype), den,
                ChainTrainConfig(batch_size=sz.egs, num_epochs=1,
                                 optimizer="ngsgd", total_steps=0))
            losses, times = [], []
            for _ in range(sz.steps):
                t0 = time.perf_counter()
                losses.append(trainer.train(egs, log_every=10 ** 9)["loss"])
                times.append(time.perf_counter() - t0)
            check(all(np.isfinite(losses)),
                  f"train: non-finite loss in {dtype}: {losses}")
            ph.checks[f"{dtype}_losses"] = ",".join(
                f"{l:.6f}" for l in losses)
            if len(times) > 1:
                ph.checks[f"{dtype}_Mframes_s"] = \
                    f"{frames / np.median(times[1:]) / 1e6:.3f}"


def synth_audio(task, sentences, seed: int = 11):
    """16 kHz waveforms of the given word sequences (pipelines/data.py)."""
    from kaldi_tpu.fst.lang import Lexicon
    from kaldi_tpu.pipelines.data import SyntheticSpeech
    words = sorted({w for s in sentences for w in s})
    lex = Lexicon([(w, task.pron_of[w]) for w in words])
    synth = SyntheticSpeech(lex, samp_freq=16000)
    rng = np.random.default_rng(seed)
    return [synth.render_words(s, rng) for s in sentences]


def phase_served(sz: Sizes, task, dec, T_pad: int) -> None:
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig
    from kaldi_tpu.features.compute import Fbank, FbankOptions
    from kaldi_tpu.features.mel import MelBanksOptions
    from kaldi_tpu.features.window import FrameExtractionOptions
    from kaldi_tpu.pipelines.largevocab import sample_eval_set
    with Phase("served") as ph:
        sents = list(sample_eval_set(task, sz.n_served, max_words=6,
                                     seed=202).values())
        waves = synth_audio(task, sents)
        fb = Fbank(FbankOptions(
            frame_opts=FrameExtractionOptions(dither=0.0),
            mel_opts=MelBanksOptions(num_bins=40)))
        here = {jax.devices()[0].platform}
        frames = [fb.frames(w) for w in waves]
        T_in = round_up(max(len(f) for f in frames), 96)
        # each utterance padded to one length: one fbank executable
        F = jnp.stack([fb.compute_frames(jnp.asarray(np.concatenate(
            [f, np.ones((T_in - len(f), f.shape[1]), np.float32)])))
            for f in frames])
        check({d.platform for d in F.devices()} == here,
              "served: fbank ran off the card")
        check(bool(jnp.isfinite(F).all()), "served: non-finite fbank")
        cfg = TdnnConfig(feat_dim=40, num_pdfs=task.num_pdfs,
                         hidden_dim=sz.hidden,
                         bottleneck_dim=sz.bottleneck,
                         num_layers=sz.layers, frame_subsampling_factor=3)
        model = TdnnChain(cfg)
        v = model.init(jax.random.PRNGKey(7), F)
        k = v["params"]["output_affine"]["kernel"]
        v["params"]["output_affine"]["kernel"] = jax.random.normal(
            jax.random.PRNGKey(8), k.shape) / np.sqrt(k.shape[0])
        scores = jax.jit(lambda vv, x: model.apply(vv, x))(v, F)
        check({d.platform for d in scores.devices()} == here,
              "served: AM ran off the card")
        check(bool(jnp.isfinite(scores).all()), "served: non-finite AM")
        S = np.asarray(scores)
        lens = np.array([len(f) // 3 for f in frames], np.int32)
        # reuse the decode phase's executable when the batch fits it
        Tp = max(T_pad, round_up(int(lens.max()), 32))
        X = np.zeros((max(sz.batch, len(lens)), Tp, task.num_pdfs),
                     np.float32)
        X[:len(lens), :S.shape[1]] = S[:, :Tp]
        lens_b = np.ones(X.shape[0], np.int32)
        lens_b[:len(lens)] = lens
        lats = dec.decode_compact_batch(X, lens_b)[:len(lens)]
        check(len(lats) == len(waves), "served: lattice count")
        check(all(np.isfinite(best(l)[1]) for l in lats),
              "served: non-finite lattice cost")
        ph.checks["utts"] = len(lats)
        ph.checks["feat_frames"] = int(sum(len(f) for f in frames))
        ph.checks["lattice_arcs"] = sum(l.num_arcs for l in lats)


def phase_four(sz: Sizes, devs) -> None:
    import jax
    from jax.sharding import Mesh
    from kaldi_tpu.decoder.beam import BeamDecoder
    from kaldi_tpu.parallel.decode import ShardedBeamDecoder
    from kaldi_tpu.parallel.mesh import make_mesh
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    with Phase("four") as ph:
        devs = list(devs[:4])
        task, _eval, utts, lls, build_s = build_task(sz)
        ph.checks["graph_build_s"] = f"{build_s:.1f}"
        dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                          decoder_config())
        # the decode phase's batch shape, over a spread of utterances
        T_pad = round_up(max(len(x) for x in lls), 32)
        pick = np.linspace(0, len(utts) - 1, sz.n_four).astype(int)
        utts = [utts[i] for i in pick]
        X, lens = pad_batch([lls[i] for i in pick], T_pad, task.num_pdfs)
        one = [best(l) for l in dec.decode_compact_batch(X, lens)]
        sharded = ShardedBeamDecoder(dec, Mesh(np.array(devs), ("data",)))
        stats = {}
        four = [best(l) for l in sharded.decode_compact_batch(X, lens,
                                                              stats)]
        g_devs = {frozenset(a.sharding.device_set) for a in
                  jax.tree_util.tree_leaves(sharded.graph_arrays())}
        check(g_devs == {frozenset(devs)},
              f"four: graph arrays not on all four cards: {g_devs}")
        check(stats["out_devices"] == 4,
              f"four: decode output on {stats['out_devices']} cards")
        for u, a, b in zip(utts, one, four):
            check(same_path(a, b), f"four: {u} sharded {b} vs one {a}")
        ph.checks["sharded_decode_agree"] = f"{len(utts)}/{len(utts)}"
        ph.checks["graph_on_cards"] = 4

        den, ccfg, tree = chain_setup(sz)
        egs = chain_egs(sz, tree.num_pdfs)
        losses = {}
        for name, mesh in (("one", None),
                           ("data4", make_mesh(data=4, model=1,
                                               devices=devs)),
                           ("data2_model2", make_mesh(data=2, model=2,
                                                      devices=devs))):
            trainer = ChainTrainer(ccfg, den, ChainTrainConfig(
                batch_size=sz.egs, num_epochs=1, optimizer="ngsgd",
                total_steps=0), mesh=mesh)
            # the first step's loss does not see the model (its output
            # layer starts at zero); the second runs after one sharded
            # update
            for _ in range(2):
                losses[name] = trainer.train(egs, log_every=10 ** 9)["loss"]
            ph.checks[f"loss_{name}"] = f"{losses[name]:.6f}"
        for name in ("data4", "data2_model2"):
            rel = abs(losses[name] - losses["one"]) / max(
                abs(losses["one"]), 1.0)
            ph.checks[f"loss_rel_err_{name}"] = f"{rel:.2e}"
            check(rel <= SHARDED_LOSS_RTOL,
                  f"four: {name} loss {losses[name]} vs {losses['one']}")


def run_single(sz: Sizes, cpu) -> None:
    """The one-card phases after the device phase."""
    task, dec, utts, lls, T_pad, offline = phase_decode(sz, cpu)
    phase_stream(sz, dec, utts, lls, offline)
    phase_train(sz)
    phase_served(sz, task, dec, T_pad)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)
    devs = require_gpu(4 if args.four else 1)
    import jax
    jax.monitoring.register_event_duration_secs_listener(_count_compile)
    from kaldi_tpu.core import jit_cache
    jit_cache.enable()
    phase_device(devs)
    if args.four:
        phase_four(Sizes(), devs)
    else:
        run_single(Sizes(), jax.devices("cpu")[0])
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("flax", "orbax"))
    check(not leaked, f"main path imported {leaked}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
