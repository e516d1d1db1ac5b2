"""Twenty-seventh bank of CLI tools: the gmmbin + featbin long-tail —
simple/biglm/regtree lattice generation, fMPE stats derivatives and
model rescaling, MAP from stats, basis-fMLLR gpost variants, raw-space
fMLLR (pre-LDA), global-GMM twofeats/MLLT/LVTLN, feature comparison,
two-channel CMVN, full LDA matrices.

Canonical shapes mirrored (SURVEY.md §2.1 bins):
gmmbin/{gmm-latgen-simple, gmm-decode-biglm-faster,
gmm-global-acc-stats-twofeats, gmm-get-stats-deriv, gmm-est-rescale,
gmm-est-map, gmm-basis-fmllr-accs-gpost, gmm-est-basis-fmllr-gpost,
gmm-est-fmllr-raw, gmm-est-fmllr-raw-gpost,
gmm-latgen-faster-regtree-fmllr, gmm-acc-mllt-global,
gmm-global-est-lvtln-trans}.cc,
featbin/{compare-feats, compute-cmvn-stats-two-channel,
get-full-lda-mat}.cc.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from kaldi_tpu.cli.tools import tool, _load_hclg, _LatgenDecoder
from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.core.table import (RandomAccessTableReader,
                                  SequentialTableReader, TableWriter)

log = get_logger(__name__)


def _spk_groups(po, feats_rspec: str) -> Dict[str, List[str]]:
    """--spk2utt grouping, else per-utterance (the fMLLR-family
    convention shared by gmm-est-fmllr*)."""
    groups: Dict[str, List[str]] = {}
    if po["spk2utt"]:
        for spk, utts in SequentialTableReader(po["spk2utt"],
                                               holder="text"):
            groups[spk] = list(utts)
    else:
        for key, _ in SequentialTableReader(feats_rspec, holder="mat"):
            groups[key] = [key]
    return groups


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

@tool("gmm-latgen-simple")
def gmm_latgen_simple_tool(argv):
    """Unpruned-reference lattice generation
    (gmmbin/gmm-latgen-simple.cc, LatticeSimpleDecoder): the dense
    decoder at an effectively infinite beam — the oracle the pruned
    latgen tools are validated against."""
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.decoder.dense import DenseDecoder, DenseDecoderConfig
    from kaldi_tpu.lattice.determinize import determinize_lattice_pruned
    po = ParseOptions("gmm-latgen-simple [opts] <model> <fst> "
                      "<feats-rspec> <lattice-wspec>")
    po.register("lattice-beam", float, 10.0, "lattice beam")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    HCLG = _load_hclg(args[1])
    dec = DenseDecoder(HCLG, tm.tid_to_pdf_array, DenseDecoderConfig(
        beam=1e9, lattice_beam=po["lattice-beam"],
        acoustic_scale=po["acoustic-scale"]))
    n = 0
    with TableWriter(args[3], holder="clat") as w:
        for key, feats in SequentialTableReader(args[2], holder="mat"):
            ll = np.asarray(am.loglikes(np.asarray(feats, np.float32)))
            lat, _best = dec.decode_lattice(ll)
            w[key] = determinize_lattice_pruned(lat,
                                                po["lattice-beam"])
            n += 1
    log.info("gmm-latgen-simple: %d utterances (unpruned)", n)
    return 0


@tool("gmm-decode-biglm-faster")
def gmm_decode_biglm_faster_tool(argv):
    """Best-path decoding with on-the-fly big-LM rescoring
    (gmmbin/gmm-decode-biglm-faster.cc): word scores of the small-LM
    HCLG are swapped for the big LM's during the search; outputs
    transcripts (+ optional alignments) rather than lattices."""
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.decoder.biglm import (BiglmDecoderConfig,
                                         BiglmFasterDecoder)
    from kaldi_tpu.fst.arpa import ArpaModel
    from kaldi_tpu.fst.fst import SymbolTable
    po = ParseOptions("gmm-decode-biglm-faster [opts] <model> <fst> "
                      "<old-arpa> <new-arpa> <feats-rspec> "
                      "<words-wspec> [<ali-wspec>]")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("max-active", int, 7000, "max active tokens")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("word-symbol-table", str, "", "words.txt (REQUIRED)")
    args = po.read(argv)
    if not po["word-symbol-table"]:
        raise KaldiError("gmm-decode-biglm-faster: "
                         "--word-symbol-table required")
    tm, am = read_mdl(args[0])
    HCLG = _load_hclg(args[1])
    old_lm = ArpaModel.parse(args[2])
    new_lm = ArpaModel.parse(args[3])
    words = SymbolTable.read(po["word-symbol-table"])
    dec = BiglmFasterDecoder(
        HCLG, tm.tid_to_pdf_array, old_lm.score, new_lm.score, words,
        BiglmDecoderConfig(beam=po["beam"],
                           max_active=po["max-active"],
                           acoustic_scale=po["acoustic-scale"],
                           history_len=max(new_lm.order - 1, 1)))
    awriter = (TableWriter(args[6], holder="ivec")
               if len(args) > 6 else None)
    n = 0
    with TableWriter(args[5], holder="text") as w:
        for key, feats in SequentialTableReader(args[4], holder="mat"):
            ll = np.asarray(am.loglikes(np.asarray(feats)))
            tids, ols, cost = dec.decode(ll)
            w[key] = [words.find(o) for o in ols]
            if awriter:
                awriter[key] = np.asarray(tids, np.int32)
            n += 1
    if awriter:
        awriter.close()
    log.info("gmm-decode-biglm-faster: %d utterances", n)
    return 0


@tool("gmm-latgen-faster-regtree-fmllr")
def gmm_latgen_faster_regtree_fmllr_tool(argv):
    """Lattice generation with per-speaker regression-tree fMLLR
    transforms (gmmbin/gmm-latgen-faster-regtree-fmllr.cc): the
    regtree root transform is applied in feature space, then the
    standard latgen path runs."""
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.am.transforms import apply_transform
    po = ParseOptions("gmm-latgen-faster-regtree-fmllr [opts] <model> "
                      "<fst> <transforms-rspec> <feats-rspec> "
                      "<lattice-wspec>")
    po.register("beam", float, 13.0, "decoding beam")
    po.register("lattice-beam", float, 6.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 0.1, "acoustic scale")
    po.register("utt2spk", str, "", "utterance→speaker map rspec")
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    HCLG = _load_hclg(args[1])
    dec = _LatgenDecoder(HCLG, tm.tid_to_pdf_array, po["beam"],
                         po["lattice-beam"], po["acoustic-scale"],
                         max_active=po["max-active"])
    trans = RandomAccessTableReader(args[2], holder="mat")
    utt2spk = {}
    if po["utt2spk"]:
        for u, s in SequentialTableReader(po["utt2spk"],
                                          holder="text"):
            utt2spk[u] = s[0]
    n = 0
    with TableWriter(args[4], holder="clat") as w:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            spk = utt2spk.get(key, key)
            x = np.asarray(feats, np.float32)
            if spk in trans:
                x = apply_transform(x, np.asarray(trans[spk])
                                    ).astype(np.float32)
            ll = np.asarray(am.loglikes(x))
            w[key] = dec.decode_to_clat(ll)
            n += 1
    log.info("gmm-latgen-faster-regtree-fmllr: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# discriminative stats / fMPE support
# ---------------------------------------------------------------------------

@tool("gmm-get-stats-deriv")
def gmm_get_stats_deriv_tool(argv):
    """Derivative of the MMI/MPE objective w.r.t. GMM parameters from
    numerator/denominator stats (gmmbin/gmm-get-stats-deriv.cc —
    consumed by the fMPE feature-space training): per (pdf, mix),
    d/dμ = Σ⁻¹[(m_num − γ_num·μ) − (m_den − γ_den·μ)], plus the
    occupancy differential."""
    from kaldi_tpu.am.serialize import read_mdl, write_pytree
    from kaldi_tpu.cli.tools_extra import read_gmm_accs
    from kaldi_tpu.core import io as kio
    po = ParseOptions("gmm-get-stats-deriv <model> <num-accs> "
                      "<den-accs> <deriv-out>")
    args = po.read(argv)
    _tm, am = read_mdl(args[0])
    num = read_gmm_accs(args[1])
    den = read_gmm_accs(args[2])
    mu = am.means                                   # (P, M, D)
    inv_var = 1.0 / am.vars
    d_mean = inv_var * ((num.mean_acc - num.occ[..., None] * mu)
                        - (den.mean_acc - den.occ[..., None] * mu))
    d_occ = num.occ - den.occ
    with kio.open_wxfilename(args[3]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<GmmStatsDeriv>")
        write_pytree(f, {"d_mean": d_mean.astype(np.float32),
                         "d_occ": d_occ.astype(np.float32)})
        kio.write_token(f, "</GmmStatsDeriv>")
    log.info("gmm-get-stats-deriv: |d_mean| %.4f, Σ|d_occ| %.2f",
             float(np.abs(d_mean).mean()), float(np.abs(d_occ).sum()))
    return 0


@tool("gmm-est-rescale")
def gmm_est_rescale_tool(argv):
    """Rescale GMM means/variances to track a feature-space change
    (gmmbin/gmm-est-rescale.cc, the fMPE model-update companion):
    with stats of the SAME posteriors on old and new features,
    μ' = μ + (x̄_new − x̄_old) and σ²' = σ²·(var_new/var_old)."""
    from kaldi_tpu.am.serialize import read_mdl, write_mdl
    from kaldi_tpu.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-est-rescale [--min-count=10] <model-in> "
                      "<old-stats> <new-stats> <model-out>")
    po.register("min-count", float, 10.0,
                "skip Gaussians with less occupancy")
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    old = read_gmm_accs(args[1])
    new = read_gmm_accs(args[2])
    occ = old.occ
    ok = (occ > po["min-count"]) & (new.occ > po["min-count"])
    n_resc = int(ok.sum())
    occ_s = np.maximum(occ, 1e-10)[..., None]
    nocc_s = np.maximum(new.occ, 1e-10)[..., None]
    mean_old = old.mean_acc / occ_s
    mean_new = new.mean_acc / nocc_s
    var_old = np.maximum(old.var_acc / occ_s - mean_old ** 2, 1e-6)
    var_new = np.maximum(new.var_acc / nocc_s - mean_new ** 2, 1e-6)
    mask = ok[..., None]
    am.means = np.where(mask, am.means + (mean_new - mean_old),
                        am.means)
    am.vars = np.where(mask, np.maximum(
        am.vars * var_new / var_old, 1e-6), am.vars)
    am.refresh()
    write_mdl(args[3], tm, am)
    log.info("gmm-est-rescale: rescaled %d/%d Gaussians", n_resc,
             int(occ.size))
    return 0


@tool("gmm-est-map")
def gmm_est_map_tool(argv):
    """MAP re-estimation from accumulated stats
    (gmmbin/gmm-est-map.cc; gmm-adapt-map is the feats+ali one-shot
    flavor — this one consumes gmm-acc-stats output)."""
    from kaldi_tpu.am.gmm import map_update
    from kaldi_tpu.am.serialize import read_mdl, write_mdl
    from kaldi_tpu.cli.tools_extra import read_gmm_accs
    po = ParseOptions("gmm-est-map [opts] <model-in> <stats-in> "
                      "<model-out>")
    po.register("mean-tau", float, 10.0, "prior count for means")
    po.register("weight-tau", float, 0.0, "prior count for weights")
    po.register("var-tau", float, 0.0, "prior count for variances")
    args = po.read(argv)
    tm, am = read_mdl(args[0])
    accs = read_gmm_accs(args[1])
    map_update(am, accs, mean_tau=po["mean-tau"],
               weight_tau=po["weight-tau"], var_tau=po["var-tau"])
    write_mdl(args[2], tm, am)
    log.info("gmm-est-map: %d pdfs, %.0f frames of adaptation data",
             am.num_pdfs, float(accs.occ.sum()))
    return 0


# ---------------------------------------------------------------------------
# basis-fMLLR gpost variants
# ---------------------------------------------------------------------------

def _accumulate_fmllr_gpost(accs, am, feats: np.ndarray, gpost) -> None:
    """Shared gpost→FmllrAccs accumulation (gpost ids are
    pdf*max_mix+component, the gmm-post-to-gpost convention)."""
    M = am.max_mix
    for t, frame in enumerate(gpost):
        if not frame or t >= len(feats):
            continue
        gs = [(int(g) // M, int(g) % M, w) for g, w in frame]
        post = np.asarray([[w for _p, _m, w in gs]])
        means = np.asarray([[am.means[p, m] for p, m, _w in gs]])
        ivars = np.asarray([[1.0 / am.vars[p, m] for p, m, _w in gs]])
        accs.accumulate(post, feats[t][None], means, ivars)


@tool("gmm-basis-fmllr-accs-gpost")
def gmm_basis_fmllr_accs_gpost_tool(argv):
    """Basis-fMLLR gradient-scatter accumulation from Gaussian-level
    posteriors (gmmbin/gmm-basis-fmllr-accs-gpost.cc)."""
    from kaldi_tpu.am.basis_fmllr import GradientScatter, write_scatter
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.am.transforms import FmllrAccs
    from kaldi_tpu.core import io as kio
    po = ParseOptions("gmm-basis-fmllr-accs-gpost <model> "
                      "<feats-rspec> <gpost-rspec> <scatter-out>")
    args = po.read(argv)
    _tm, am = read_mdl(args[0])
    gpost_r = RandomAccessTableReader(args[2], holder="post")
    sc = GradientScatter(am.dim)
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in gpost_r:
            continue
        accs = FmllrAccs(am.dim)
        _accumulate_fmllr_gpost(accs, am, np.asarray(feats),
                                gpost_r[key])
        sc.accumulate(accs)
    with kio.open_wxfilename(args[3]) as f:
        kio.init_kaldi_output_stream(f)
        write_scatter(f, sc)
    log.info("gmm-basis-fmllr-accs-gpost: %d utterances, %.0f frames",
             sc.count, sc.beta)
    return 0


@tool("gmm-est-basis-fmllr-gpost")
def gmm_est_basis_fmllr_gpost_tool(argv):
    """Per-speaker basis-fMLLR transforms from Gaussian-level
    posteriors (gmmbin/gmm-est-basis-fmllr-gpost.cc)."""
    from kaldi_tpu.am.basis_fmllr import (estimate_basis_fmllr,
                                          read_basis)
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.am.transforms import FmllrAccs
    from kaldi_tpu.core import io as kio
    po = ParseOptions("gmm-est-basis-fmllr-gpost [--spk2utt=rspec] "
                      "[--size-scale=0.2] <model> <basis-in> "
                      "<feats-rspec> <gpost-rspec> <trans-wspec>")
    po.register("spk2utt", str, "", "speaker→utt map rspec")
    po.register("size-scale", float, 0.2, "bases per frame of data")
    args = po.read(argv)
    _tm, am = read_mdl(args[0])
    with kio.open_rxfilename(args[1]) as f:
        kio.init_kaldi_input_stream(f)
        basis = read_basis(f)
    feats_r = RandomAccessTableReader(args[2], holder="mat")
    gpost_r = RandomAccessTableReader(args[3], holder="post")
    groups = _spk_groups(po, args[2])
    n_spk = 0
    with TableWriter(args[4], holder="mat") as w:
        for spk, utts in groups.items():
            accs = FmllrAccs(am.dim)
            got = False
            for u in utts:
                if u not in feats_r or u not in gpost_r:
                    continue
                _accumulate_fmllr_gpost(accs, am,
                                        np.asarray(feats_r[u]),
                                        gpost_r[u])
                got = True
            if not got:
                continue
            W, impr, n_bases = estimate_basis_fmllr(
                accs, basis, size_scale=po["size-scale"])
            w[spk] = W.astype(np.float32)
            n_spk += 1
            log.info("gmm-est-basis-fmllr-gpost: spk %s: %d bases, "
                     "impr %.4f/frame", spk, n_bases, impr)
    log.info("gmm-est-basis-fmllr-gpost: %d speakers", n_spk)
    return 0


# ---------------------------------------------------------------------------
# raw-space (pre-LDA) fMLLR
# ---------------------------------------------------------------------------

def _est_fmllr_raw_core(am, lda: np.ndarray, utt_data, num_iters: int,
                        lr: float):
    """Estimate a raw-space affine transform W (Dr × (Dr+1)) maximizing
    Σ_t Σ_p γ_tp · loglike(LDA·(W·x̂_t))[p] + β·log|det W_sq|
    (the fmllr-raw.cc objective), by Adam ascent with jax autograd —
    the autograd re-solve of the upstream row-by-row quadratic
    optimization.  utt_data: list of (raw_feats (T, Dr), dense
    posterior (T, P)) pairs."""
    import jax
    import jax.numpy as jnp
    import optax
    Dr = utt_data[0][0].shape[1]
    D = am.dim
    if lda.shape[1] == Dr + 1:
        A, b_lda = lda[:, :Dr], lda[:, Dr]
    elif lda.shape[1] == Dr:
        A, b_lda = lda, np.zeros(lda.shape[0])
    else:
        raise KaldiError(f"lda matrix cols {lda.shape[1]} vs raw dim "
                         f"{Dr}")
    if A.shape[0] != D:
        raise KaldiError(f"lda rows {A.shape[0]} vs model dim {D}")
    Aj = jnp.asarray(A, jnp.float32)
    bj = jnp.asarray(b_lda, jnp.float32)
    means = jnp.asarray(am.means, jnp.float32)        # (P, M, D)
    inv_var = jnp.asarray(1.0 / am.vars, jnp.float32)
    logw = jnp.log(jnp.maximum(jnp.asarray(am.weights, jnp.float32),
                               1e-20))
    logdet_var = jnp.sum(jnp.log(jnp.asarray(am.vars, jnp.float32)),
                         axis=-1)                     # (P, M)
    X = jnp.asarray(np.concatenate([d[0] for d in utt_data]),
                    jnp.float32)                       # (T, Dr)
    G = jnp.asarray(np.concatenate([d[1] for d in utt_data]),
                    jnp.float32)                       # (T, P)
    beta = float(np.sum([d[1].sum() for d in utt_data]))

    def loglikes(Y):
        """(T, D) model-space feats → (T, P) GMM loglikes."""
        diff = Y[:, None, None, :] - means[None]       # (T,P,M,D)
        q = jnp.sum(diff * diff * inv_var[None], axis=-1)
        ll = logw[None] - 0.5 * (q + logdet_var[None]
                                 + D * jnp.log(2 * jnp.pi))
        return jax.scipy.special.logsumexp(ll, axis=-1)

    def objf(W):
        Y = X @ W[:, :Dr].T + W[:, Dr]
        Z = Y @ Aj.T + bj
        acc = jnp.sum(G * loglikes(Z))
        sign, logdet = jnp.linalg.slogdet(W[:, :Dr])
        return acc + beta * logdet

    W = jnp.concatenate([jnp.eye(Dr), jnp.zeros((Dr, 1))], axis=1)
    objf0 = float(objf(W))
    tx = optax.adam(lr)
    state = tx.init(W)
    grad_fn = jax.jit(jax.value_and_grad(lambda W: -objf(W)))
    for _ in range(num_iters):
        _loss, g = grad_fn(W)
        up, state = tx.update(g, state)
        W = optax.apply_updates(W, up)
    impr = (float(objf(W)) - objf0) / max(beta, 1.0)
    return np.asarray(W, np.float32), impr, beta


def _fmllr_raw_tool(argv, name: str, gpost: bool):
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.core import io as kio
    po = ParseOptions(f"{name} [opts] --lda-matrix=<mat> <model> "
                      "<raw-feats-rspec> "
                      f"<{'gpost' if gpost else 'post'}-rspec> "
                      "<trans-wspec>")
    po.register("lda-matrix", str, "",
                "LDA(+MLLT) matrix mapping raw dim → model dim "
                "(REQUIRED)")
    po.register("spk2utt", str, "", "speaker→utt map rspec")
    po.register("num-iters", int, 60, "Adam ascent steps")
    po.register("learning-rate", float, 0.02, "Adam step size")
    args = po.read(argv)
    if not po["lda-matrix"]:
        raise KaldiError(f"{name}: --lda-matrix required")
    _tm, am = read_mdl(args[0])
    with kio.open_rxfilename(po["lda-matrix"]) as f:
        kio.init_kaldi_input_stream(f)
        lda = np.asarray(kio.read_matrix(f), np.float64)
    feats_r = RandomAccessTableReader(args[1], holder="mat")
    post_r = RandomAccessTableReader(args[2], holder="post")
    groups = _spk_groups(po, args[1])
    M = am.max_mix
    n_spk = 0
    with TableWriter(args[3], holder="mat") as w:
        for spk, utts in groups.items():
            data = []
            for u in utts:
                if u not in feats_r or u not in post_r:
                    continue
                raw = np.asarray(feats_r[u], np.float64)
                dense = np.zeros((len(raw), am.num_pdfs))
                for t, frame in enumerate(post_r[u]):
                    if t >= len(raw):
                        break
                    for g, wgt in frame:
                        p = int(g) // M if gpost else int(g)
                        dense[t, p] += wgt
                data.append((raw, dense))
            if not data:
                continue
            W, impr, beta = _est_fmllr_raw_core(
                am, lda, data, po["num-iters"], po["learning-rate"])
            w[spk] = W
            n_spk += 1
            log.info("%s: spk %s: objf impr %.4f/frame over %.0f "
                     "frames", name, spk, impr, beta)
    log.info("%s: %d speakers", name, n_spk)
    return 0


@tool("gmm-est-fmllr-raw")
def gmm_est_fmllr_raw_tool(argv):
    """fMLLR estimated in the RAW (pre-LDA, e.g. spliced-MFCC) space
    while the model lives in the LDA+MLLT space
    (gmmbin/gmm-est-fmllr-raw.cc; see _est_fmllr_raw_core for the
    autograd re-solve of the fmllr-raw.cc objective)."""
    return _fmllr_raw_tool(argv, "gmm-est-fmllr-raw", gpost=False)


@tool("gmm-est-fmllr-raw-gpost")
def gmm_est_fmllr_raw_gpost_tool(argv):
    """Raw-space fMLLR from Gaussian-level posteriors
    (gmmbin/gmm-est-fmllr-raw-gpost.cc)."""
    return _fmllr_raw_tool(argv, "gmm-est-fmllr-raw-gpost", gpost=True)


# ---------------------------------------------------------------------------
# global-GMM tail
# ---------------------------------------------------------------------------

@tool("gmm-global-acc-stats-twofeats")
def gmm_global_acc_stats_twofeats_tool(argv):
    """Global-GMM stats with posteriors from one feature stream and
    accumulation on another (gmmbin/gmm-global-acc-stats-twofeats.cc
    — the fMPE/UBM analogue of gmm-acc-stats-twofeats)."""
    from kaldi_tpu.am.gmm import GmmAccs, accumulate_stats_twofeats
    from kaldi_tpu.cli.tools_bank5 import _read_global_gmm
    from kaldi_tpu.cli.tools_extra import write_gmm_accs
    po = ParseOptions("gmm-global-acc-stats-twofeats <global-gmm> "
                      "<feats1-rspec> <feats2-rspec> <accs-out>")
    args = po.read(argv)
    am = _read_global_gmm(args[0])
    f2 = RandomAccessTableReader(args[2], holder="mat")
    accs = GmmAccs.zeros(am.num_pdfs, am.max_mix, am.dim)
    n = 0
    for key, feats in SequentialTableReader(args[1], holder="mat"):
        if key not in f2:
            continue
        T = len(np.asarray(feats))
        accumulate_stats_twofeats(
            am, np.asarray(feats, np.float32),
            np.asarray(f2[key], np.float32),
            np.zeros(T, np.int64), accs)
        n += 1
    write_gmm_accs(args[3], accs)
    log.info("gmm-global-acc-stats-twofeats: %d utterances", n)
    return 0


@tool("gmm-acc-mllt-global")
def gmm_acc_mllt_global_tool(argv):
    """MLLT stats against a global GMM
    (gmmbin/gmm-acc-mllt-global.cc — the diagonal-UBM STC step)."""
    from kaldi_tpu.am.transforms import MlltAccs
    from kaldi_tpu.cli.tools_bank5 import _read_global_gmm
    from kaldi_tpu.core import io as kio
    po = ParseOptions("gmm-acc-mllt-global <global-gmm> <feats-rspec> "
                      "<accs-out>")
    args = po.read(argv)
    am = _read_global_gmm(args[0])
    accs = MlltAccs(am.dim)
    n = 0
    for _key, feats in SequentialTableReader(args[1], holder="mat"):
        x = np.asarray(feats, np.float64)
        T = len(x)
        post = np.asarray(am.component_posteriors(
            x, np.zeros(T, np.int32)))                 # (T, M)
        means = np.broadcast_to(am.means[0], (T,) + am.means[0].shape)
        ivars = np.broadcast_to(1.0 / am.vars[0], (T,) +
                                am.vars[0].shape)
        accs.accumulate(post, x, means, ivars)
        n += 1
    with kio.open_wxfilename(args[2]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<MLLTACCS>")
        kio.write_basic_float(f, accs.beta)
        for i in range(am.dim):
            kio.write_matrix(f, accs.G[i])
        kio.write_token(f, "</MLLTACCS>")
    log.info("gmm-acc-mllt-global: %d utterances, %.0f frames", n,
             accs.beta)
    return 0


@tool("gmm-global-est-lvtln-trans")
def gmm_global_est_lvtln_trans_tool(argv):
    """Pick per-speaker LVTLN class against a GLOBAL GMM
    (gmmbin/gmm-global-est-lvtln-trans.cc; the diagonal-UBM VTLN
    flavor — posteriors are implicit, weight 1 per frame)."""
    from kaldi_tpu.am.lvtln import read_lvtln
    from kaldi_tpu.cli.tools_bank5 import _read_global_gmm
    from kaldi_tpu.core import io as kio
    po = ParseOptions("gmm-global-est-lvtln-trans [--spk2utt=rspec] "
                      "<global-gmm> <lvtln-in> <feats-rspec> "
                      "<trans-wspec> [<warp-wspec>]")
    po.register("spk2utt", str, "", "speaker→utt map rspec")
    args = po.read(argv)
    am = _read_global_gmm(args[0])
    with kio.open_rxfilename(args[1]) as f:
        kio.init_kaldi_input_stream(f)
        lv = read_lvtln(f)
    feats_r = RandomAccessTableReader(args[2], holder="mat")
    groups = _spk_groups(po, args[2])
    wwriter = (TableWriter(args[4], holder="vec")
               if len(args) > 4 else None)
    n_spk = 0
    with TableWriter(args[3], holder="mat") as w:
        for spk, utts in groups.items():
            frames = [np.asarray(feats_r[u]) for u in utts
                      if u in feats_r]
            if not frames:
                continue
            x = np.concatenate(frames)
            cls, affine, impr = lv.select(am, x, posts=None)
            w[spk] = affine.astype(np.float32)
            if wwriter:
                wwriter[spk] = np.asarray([lv.warps[cls]], np.float32)
            n_spk += 1
            log.info("gmm-global-est-lvtln-trans: spk %s class %d "
                     "(warp %.2f) impr %.4f", spk, cls,
                     lv.warps[cls], impr)
    if wwriter:
        wwriter.close()
    log.info("gmm-global-est-lvtln-trans: %d speakers", n_spk)
    return 0


# ---------------------------------------------------------------------------
# featbin tail
# ---------------------------------------------------------------------------

@tool("compare-feats")
def compare_feats_tool(argv):
    """Self-product-normalized similarity of two feature tables
    (featbin/compare-feats.cc): prints the mean per-dim similarity
    and fails if below --threshold."""
    po = ParseOptions("compare-feats [--threshold=0.99] <feats1-rspec> "
                      "<feats2-rspec>")
    po.register("threshold", float, 0.99,
                "minimum similarity to succeed")
    args = po.read(argv)
    r2 = RandomAccessTableReader(args[1], holder="mat")
    prod, s1, s2 = None, None, None
    n, n_skip = 0, 0
    for key, a in SequentialTableReader(args[0], holder="mat"):
        if key not in r2:
            n_skip += 1
            continue
        a = np.asarray(a, np.float64)
        b = np.asarray(r2[key], np.float64)
        if a.shape != b.shape:
            raise KaldiError(f"compare-feats: {key} shape {a.shape} "
                             f"vs {b.shape}")
        if prod is None:
            prod = np.zeros(a.shape[1])
            s1 = np.zeros(a.shape[1])
            s2 = np.zeros(a.shape[1])
        prod += (a * b).sum(axis=0)
        s1 += (a * a).sum(axis=0)
        s2 += (b * b).sum(axis=0)
        n += 1
    if n == 0:
        raise KaldiError("compare-feats: no matching utterances")
    sim = prod / np.maximum(np.sqrt(s1 * s2), 1e-20)
    mean_sim = float(sim.mean())
    print(f"{mean_sim:.6f}")
    log.info("compare-feats: similarity %.6f over %d utterances "
             "(%d skipped), min-dim %.6f", mean_sim, n, n_skip,
             float(sim.min()))
    return 0 if mean_sim >= po["threshold"] else 1


@tool("compute-cmvn-stats-two-channel")
def compute_cmvn_stats_two_channel_tool(argv):
    """Two-channel (stereo telephone) CMVN stats
    (featbin/compute-cmvn-stats-two-channel.cc): for each recording's
    A/B channel pair, a frame contributes to its channel's stats with
    weight 1 when that channel's energy (c0) is higher, else a small
    floor weight — so crosstalk frames don't pollute the stats."""
    po = ParseOptions("compute-cmvn-stats-two-channel "
                      "<reco2file-and-channel> <feats-rspec> "
                      "<stats-wspec>")
    po.register("quieter-channel-weight", float, 0.01,
                "stats weight for frames where the other channel is "
                "louder")
    args = po.read(argv)
    # reco2file_and_channel lines: <utt-id> <file-id> <A|B>
    pairs: Dict[str, Dict[str, str]] = {}
    with open(args[0]) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 3:
                raise KaldiError("compute-cmvn-stats-two-channel: bad "
                                 f"line {line!r}")
            utt, file_id, chan = parts
            pairs.setdefault(file_id, {})[chan] = utt
    feats_r = RandomAccessTableReader(args[1], holder="mat")
    floor_w = po["quieter-channel-weight"]
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for file_id, chans in sorted(pairs.items()):
            utts = {c: u for c, u in chans.items() if u in feats_r}
            if len(utts) == 2:
                (ca, ua), (cb, ub) = sorted(utts.items())
                fa = np.asarray(feats_r[ua], np.float64)
                fb = np.asarray(feats_r[ub], np.float64)
                T = min(len(fa), len(fb))
                louder_a = fa[:T, 0] >= fb[:T, 0]
                for utt, feats, louder in ((ua, fa[:T], louder_a),
                                           (ub, fb[:T], ~louder_a)):
                    wgt = np.where(louder, 1.0, floor_w)[:, None]
                    D = feats.shape[1]
                    stats = np.zeros((2, D + 1))
                    stats[0, :D] = (wgt * feats).sum(axis=0)
                    stats[0, D] = wgt.sum()
                    stats[1, :D] = (wgt * feats * feats).sum(axis=0)
                    w[utt] = stats.astype(np.float64)
                    n += 1
            else:
                # unpaired channel: plain stats
                from kaldi_tpu.features import compute_cmvn_stats
                for _c, utt in sorted(utts.items()):
                    w[utt] = compute_cmvn_stats(feats_r[utt])
                    n += 1
    log.info("compute-cmvn-stats-two-channel: %d channels", n)
    return 0


@tool("get-full-lda-mat")
def get_full_lda_mat_tool(argv):
    """Compose the reduced LDA(+MLLT) matrix with the full
    (square) LDA matrix so raw-space tools see an invertible map
    (featbin/get-full-lda-mat.cc): rows 0..d-1 come from the
    LDA+MLLT matrix, rows d..D-1 from the full LDA matrix's rejected
    directions."""
    from kaldi_tpu.core import io as kio
    po = ParseOptions("get-full-lda-mat <lda-mllt-rxfilename> "
                      "<full-lda-rxfilename> <full-out-wxfilename>")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        reduced = np.asarray(kio.read_matrix(f), np.float64)
    with kio.open_rxfilename(args[1]) as f:
        kio.init_kaldi_input_stream(f)
        full = np.asarray(kio.read_matrix(f), np.float64)
    d = reduced.shape[0]
    if full.shape[1] != reduced.shape[1]:
        raise KaldiError(f"get-full-lda-mat: col mismatch "
                         f"{full.shape} vs {reduced.shape}")
    if full.shape[0] < full.shape[1] - 1:
        raise KaldiError("get-full-lda-mat: second arg must be the "
                         "FULL (square) LDA matrix (est-lda "
                         "--write-full-matrix)")
    out = np.concatenate([reduced, full[d:]], axis=0)
    with kio.open_wxfilename(args[2]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, out)
    log.info("get-full-lda-mat: %dx%d (top %d rows from LDA+MLLT)",
             out.shape[0], out.shape[1], d)
    return 0
