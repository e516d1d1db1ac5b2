"""CLI bank 31: the final upstream tail — nnet2bin model-surgery and
feature-transform tools, nnet2 discriminative (sequence) training,
incremental nnet3 lattice generation, diarization calibration,
goodness-of-pronunciation, and the device-availability probe.

Canonical shapes mirrored (SURVEY.md §2.1 bins):
nnet2bin/{nnet-am-limit-rank, nnet-am-reinitialize,
nnet-compute-from-egs, nnet-get-feature-transform,
nnet-get-feature-transform-multi, nnet-modify-learning-rates,
nnet-normalize-stddev, nnet-train-discriminative-simple,
nnet-train-discriminative-parallel}.cc,
nnet3bin/nnet3-latgen-incremental.cc,
ivectorbin/{logistic-regression-copy, compute-calibration}.cc,
bin/compute-gop.cc, nnetbin/cuda-gpu-available.cc.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu.cli.tools import tool, _load_hclg
from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.core.options import ParseOptions
from kaldi_tpu.core.table import (RandomAccessTableReader,
                                  SequentialTableReader, TableWriter)

log = get_logger(__name__)


# ---------------------------------------------------------------------------
# device probe (nnetbin/cuda-gpu-available.cc role)
# ---------------------------------------------------------------------------

@tool("cuda-gpu-available")
def cuda_gpu_available_tool(argv):
    """Report whether a CUDA GPU is usable (nnetbin/cuda-gpu-available.cc;
    recipes gate GPU stages on its exit status).  Exit 0 when JAX's
    default device is a GPU, 1 otherwise."""
    import jax
    po = ParseOptions("cuda-gpu-available")
    po.read(argv)
    devs = jax.devices()
    log.info("cuda-gpu-available: platform=%s devices=%s",
             devs[0].platform, [str(d) for d in devs])
    if devs[0].platform != "gpu":
        log.warning("cuda-gpu-available: no GPU (platform %s)",
                    devs[0].platform)
        return 1
    return 0


# ---------------------------------------------------------------------------
# ivectorbin tail
# ---------------------------------------------------------------------------

@tool("logistic-regression-copy")
def logistic_regression_copy_tool(argv):
    """Copy a logistic-regression model, optionally rescaling class
    priors (ivectorbin/logistic-regression-copy.cc --scale-priors):
    adding log(scale_c) to class c's bias column multiplies its
    posterior by scale_c before renormalization."""
    from kaldi_tpu.core import io as kio
    po = ParseOptions("logistic-regression-copy [opts] <model-in> "
                      "<model-out>")
    po.register("scale-priors", str, "",
                "rxfilename of a vector of per-class prior scales")
    args = po.read(argv)
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<LogisticRegression>")
        W = np.asarray(kio.read_matrix(f), np.float64)
        kio.expect_token(f, "</LogisticRegression>")
    if po["scale-priors"]:
        with kio.open_rxfilename(po["scale-priors"]) as f:
            kio.init_kaldi_input_stream(f)
            scales = np.asarray(kio.read_vector(f), np.float64)
        if len(scales) != W.shape[0]:
            raise KaldiError(
                f"logistic-regression-copy: {len(scales)} prior "
                f"scales for {W.shape[0]} classes")
        if np.any(scales <= 0):
            raise KaldiError("logistic-regression-copy: prior scales "
                             "must be positive")
        W[:, -1] += np.log(scales)
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<LogisticRegression>")
        kio.write_matrix(f, W.astype(np.float32))
        kio.write_token(f, "</LogisticRegression>")
    log.info("logistic-regression-copy: %d classes, dim %d%s",
             W.shape[0], W.shape[1] - 1,
             " (priors rescaled)" if po["scale-priors"] else "")
    return 0


@tool("compute-calibration")
def compute_calibration_tool(argv):
    """Fit a 2-component 1-D GMM to pairwise scores and write the
    decision threshold where the components' posteriors cross
    (ivectorbin/compute-calibration.cc — speaker-diarization
    same/different calibration)."""
    from kaldi_tpu.core import io as kio
    po = ParseOptions("compute-calibration [opts] <scores-rspec> "
                      "<threshold-wxfilename>")
    po.register("num-iters", int, 50, "EM iterations")
    args = po.read(argv)
    xs: List[float] = []
    for _key, v in SequentialTableReader(args[0], holder="vec"):
        xs.extend(np.asarray(v, np.float64).ravel().tolist())
    if len(xs) < 2:
        raise KaldiError("compute-calibration: need >=2 scores")
    x = np.asarray(xs)
    # init from the empirical halves
    mu = np.array([np.percentile(x, 25), np.percentile(x, 75)])
    var = np.array([x.var() + 1e-6] * 2)
    w = np.array([0.5, 0.5])
    for _ in range(po["num-iters"]):
        # E step: responsibilities under the two Gaussians
        ll = (-0.5 * (x[:, None] - mu) ** 2 / var
              - 0.5 * np.log(2 * np.pi * var) + np.log(w))
        ll -= ll.max(axis=1, keepdims=True)
        r = np.exp(ll)
        r /= r.sum(axis=1, keepdims=True)
        n = r.sum(axis=0) + 1e-10
        mu = (r * x[:, None]).sum(axis=0) / n
        var = (r * (x[:, None] - mu) ** 2).sum(axis=0) / n + 1e-6
        w = n / n.sum()
    lo, hi = (0, 1) if mu[0] < mu[1] else (1, 0)
    # threshold = equal-posterior point between the means (bisection)
    a, b = mu[lo], mu[hi]
    for _ in range(60):
        m = 0.5 * (a + b)
        p = (-0.5 * (m - mu) ** 2 / var
             - 0.5 * np.log(var) + np.log(w))
        if p[lo] > p[hi]:
            a = m
        else:
            b = m
    thr = 0.5 * (a + b)
    with kio.open_wxfilename(args[1]) as f:
        f.write(f"{thr:.6f}\n".encode())
    log.info("compute-calibration: %d scores, means %.3f/%.3f, "
             "threshold %.4f", len(x), mu[lo], mu[hi], thr)
    return 0


# ---------------------------------------------------------------------------
# goodness of pronunciation (bin/compute-gop.cc)
# ---------------------------------------------------------------------------

@tool("compute-gop")
def compute_gop_tool(argv):
    """Goodness of Pronunciation from per-frame pdf log-posteriors +
    a transition-id alignment (bin/compute-gop.cc): for each aligned
    phone segment, GOP = mean over frames of
    (log p(canonical phone) − max_q log p(q)), where a phone's frame
    log-posterior is the logsumexp over its pdfs.  Writes one GOP
    value per phone segment plus the phone ids."""
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions("compute-gop [opts] <model> <ali-rspec> "
                      "<prob-rspec> <gop-wspec> [<phones-wspec>]")
    args = po.read(argv)
    tm, _ = read_mdl(args[0])
    # pdf -> phones incidence from the transition model
    num_pdfs = tm.num_pdfs
    phones = sorted({tm.transition_id_to_phone(t)
                     for t in range(1, tm.num_transition_ids + 1)})
    ph_index = {p: i for i, p in enumerate(phones)}
    incidence = np.zeros((len(phones), num_pdfs), bool)
    for t in range(1, tm.num_transition_ids + 1):
        incidence[ph_index[tm.transition_id_to_phone(t)],
                  tm.transition_id_to_pdf(t)] = True
    ali_r = RandomAccessTableReader(args[1], holder="ivec")
    pw = TableWriter(args[4], holder="ivec") if len(args) > 4 else None
    n = 0
    with TableWriter(args[3], holder="vec") as gw:
        for key, probs in SequentialTableReader(args[2], holder="mat"):
            if key not in ali_r:
                log.warning("compute-gop: no alignment for %s", key)
                continue
            lp = np.asarray(probs, np.float64)  # (T, num_pdfs) log-post
            ali = np.asarray(ali_r[key], np.int64)
            T = min(len(lp), len(ali))
            lp, ali = lp[:T], ali[:T]
            # (T, P) phone log-posterior: logsumexp of member pdfs
            mx = lp.max(axis=1, keepdims=True)
            ex = np.exp(lp - mx)
            php = np.full((T, len(phones)), -1e10)
            for i in range(len(phones)):
                s = ex[:, incidence[i]].sum(axis=1)
                php[:, i] = np.where(s > 0, np.log(np.maximum(s, 1e-300))
                                     + mx[:, 0], -1e10)
            frame_ph = np.asarray(
                [ph_index[tm.transition_id_to_phone(int(t))]
                 for t in ali])
            # split into phone segments
            gops, seg_phones = [], []
            t0 = 0
            for t in range(1, T + 1):
                if t == T or frame_ph[t] != frame_ph[t0]:
                    i = frame_ph[t0]
                    seg = slice(t0, t)
                    gop = float(np.mean(php[seg, i]
                                        - php[seg].max(axis=1)))
                    gops.append(gop)
                    seg_phones.append(phones[i])
                    t0 = t
            gw[key] = np.asarray(gops, np.float32)
            if pw is not None:
                pw[key] = np.asarray(seg_phones, np.int32)
            n += 1
    if pw is not None:
        pw.close()
    log.info("compute-gop: %d utterances", n)
    return 0


# ---------------------------------------------------------------------------
# nnet2bin model surgery
# ---------------------------------------------------------------------------

@tool("nnet-am-limit-rank")
def nnet_am_limit_rank_tool(argv):
    """SVD-truncate each hidden affine's weight matrix to a reduced
    rank, keeping the reconstruction W ≈ U_k Σ_k V_kᵀ in place
    (nnet2bin/nnet-am-limit-rank.cc)."""
    from kaldi_tpu.am.nnet2 import layer_names, load_nnet2_full, \
        save_nnet2
    po = ParseOptions("nnet-am-limit-rank [opts] <nnet2-in> "
                      "<nnet2-out>")
    po.register("dim", int, 0, "rank to keep (0 ⇒ use "
                "--parameter-proportion)")
    po.register("parameter-proportion", float, 0.75,
                "keep enough singular values to approximately halve... "
                "fraction of parameters to retain when --dim=0")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    params = dict(params)
    for name in layer_names(cfg)[:-1]:   # hidden layers only
        layer = {k: np.asarray(v) for k, v in
                 dict(params[name]["affine"]).items()}
        W = layer["kernel"].astype(np.float64)  # (in, out)
        full = min(W.shape)
        if po["dim"] > 0:
            k = min(po["dim"], full)
        else:
            # rank such that the factored form U_k, V_k holds
            # parameter-proportion of the original matrix's params
            k = max(1, int(po["parameter-proportion"] * W.size
                           / (W.shape[0] + W.shape[1])))
            k = min(k, full)
        U, S, Vt = np.linalg.svd(W, full_matrices=False)
        kept = float((S[:k] ** 2).sum() / max((S ** 2).sum(), 1e-30))
        layer["kernel"] = (U[:, :k] * S[:k]) @ Vt[:k]
        layer["kernel"] = layer["kernel"].astype(np.float32)
        params[name] = {"affine": layer}
        log.info("nnet-am-limit-rank: %s rank %d/%d (%.1f%% energy)",
                 name, k, full, 100 * kept)
    save_nnet2(args[1], params, cfg, priors)
    return 0


@tool("nnet-am-reinitialize")
def nnet_am_reinitialize_tool(argv):
    """Re-target a trained net at a NEW transition model's pdf set:
    hidden layers are kept, the output affine is re-initialized at the
    new dimension (nnet2bin/nnet-am-reinitialize.cc — the transfer-
    learning step of the multilingual recipes)."""
    from kaldi_tpu.am.nnet2 import Nnet2Config, layer_names, \
        load_nnet2_full, save_nnet2
    from kaldi_tpu.am.serialize import read_mdl
    po = ParseOptions("nnet-am-reinitialize [opts] <nnet2-in> "
                      "<mdl-with-new-tree> <nnet2-out>")
    po.register("srand", int, 0, "seed for the new output layer")
    args = po.read(argv)
    params, cfg, _priors = load_nnet2_full(args[0])
    tm, _ = read_mdl(args[1])
    new_pdfs = tm.num_pdfs
    params = dict(params)
    rng = np.random.default_rng(po["srand"])
    in_dim = np.asarray(
        params["output_affine"]["kernel"]).shape[0]
    params["output_affine"] = {
        "kernel": (rng.standard_normal((in_dim, new_pdfs))
                   / np.sqrt(in_dim)).astype(np.float32),
        "bias": np.zeros(new_pdfs, np.float32),
    }
    import dataclasses as _dc
    new_cfg = _dc.replace(cfg, num_pdfs=new_pdfs, mix2pdf=None,
                          learn_rates=None)
    save_nnet2(args[2], params, new_cfg, priors=None)
    log.info("nnet-am-reinitialize: output %d → %d pdfs "
             "(%d hidden layers kept)", cfg.num_pdfs, new_pdfs,
             len(layer_names(cfg)) - 1)
    return 0


@tool("nnet-compute-from-egs")
def nnet_compute_from_egs_tool(argv):
    """Forward-propagate training examples and write the network's
    log-posterior output per eg (nnet2bin/nnet-compute-from-egs.cc —
    used by the combination/diagnostic scripts)."""
    import jax
    from kaldi_tpu.am.nnet2 import Nnet2Model, load_nnet2
    po = ParseOptions("nnet-compute-from-egs <nnet2-in> <egs-rspec> "
                      "<feats-wspec>")
    args = po.read(argv)
    params, cfg = load_nnet2(args[0])
    model = Nnet2Model(cfg)
    fwd = jax.jit(lambda x: model.apply({"params": params}, x))
    n = 0
    with TableWriter(args[2], holder="mat") as w:
        for key, eg in SequentialTableReader(args[1], holder="xeg"):
            x = np.asarray(eg.feats, np.float32)   # (B, T, D)
            out = np.asarray(fwd(x))               # (B, T, num_pdfs)
            w[key] = out.reshape(-1, out.shape[-1]).astype(np.float32)
            n += 1
    log.info("nnet-compute-from-egs: %d egs", n)
    return 0


@tool("nnet-get-feature-transform")
def nnet_get_feature_transform_tool(argv):
    """Compute the nnet2 input feature transform from LDA-style stats
    (nnet2bin/nnet-get-feature-transform.cc): a NON-dimension-reducing
    LDA whose within-class variance is scaled by
    --within-class-factor, so directions with low discrimination are
    shrunk rather than dropped."""
    from kaldi_tpu.am.transforms import LdaEstimate
    from kaldi_tpu.core import io as kio
    po = ParseOptions("nnet-get-feature-transform [opts] <mat-out> "
                      "<lda-acc1> [<lda-acc2> ...]")
    po.register("dim", int, 0, "output dim (0 ⇒ full input dim)")
    po.register("within-class-factor", float, 0.001,
                "scale on the within-class variance")
    args = po.read(argv)
    lda = None
    for acc_path in args[1:]:
        with kio.open_rxfilename(acc_path) as f:
            kio.init_kaldi_input_stream(f)
            kio.expect_token(f, "<LDAACCS>")
            counts = np.asarray(kio.read_matrix(f))[0]
            first = np.asarray(kio.read_matrix(f))
            second = np.asarray(kio.read_matrix(f))
            kio.expect_token(f, "</LDAACCS>")
        if lda is None:
            lda = LdaEstimate(len(counts), first.shape[1])
        lda.counts += counts
        lda.first += first
        lda.total_second += second
    if lda is None:
        raise KaldiError("nnet-get-feature-transform: no accs")
    dim = po["dim"] or lda.first.shape[1]
    mat = lda.estimate(dim, within_class_factor=po[
        "within-class-factor"])
    with kio.open_wxfilename(args[0]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, mat.astype(np.float32))
    log.info("nnet-get-feature-transform: %s transform "
             "(within-class-factor %g)", mat.shape,
             po["within-class-factor"])
    return 0


@tool("nnet-get-feature-transform-multi")
def nnet_get_feature_transform_multi_tool(argv):
    """Block version for multi-context inputs
    (nnet2bin/nnet-get-feature-transform-multi.cc role): the LDA acc
    is over D·N-dim spliced features; --context-groups partitions the
    N context positions (colon-separated groups of comma-separated
    indexes) and one transform is estimated per group on its own
    sub-blocks, stacked block-diagonally."""
    from kaldi_tpu.am.transforms import LdaEstimate
    from kaldi_tpu.core import io as kio
    po = ParseOptions("nnet-get-feature-transform-multi [opts] "
                      "<lda-acc> <mat-out>")
    po.register("context-groups", str, "", "e.g. 0,1,2:3,4 "
                "(REQUIRED) — groups of context positions")
    po.register("feat-dim", int, 0, "per-context feature dim "
                "(REQUIRED)")
    po.register("within-class-factor", float, 0.001,
                "scale on the within-class variance")
    args = po.read(argv)
    if not po["context-groups"] or po["feat-dim"] <= 0:
        raise KaldiError("nnet-get-feature-transform-multi: "
                         "--context-groups and --feat-dim required")
    D = po["feat-dim"]
    with kio.open_rxfilename(args[0]) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<LDAACCS>")
        counts = np.asarray(kio.read_matrix(f))[0]
        first = np.asarray(kio.read_matrix(f))
        second = np.asarray(kio.read_matrix(f))
        kio.expect_token(f, "</LDAACCS>")
    total = first.shape[1]
    if total % D:
        raise KaldiError(f"acc dim {total} not a multiple of "
                         f"--feat-dim {D}")
    groups = [[int(i) for i in g.split(",") if i != ""]
              for g in po["context-groups"].split(":")]
    blocks: List[Tuple[np.ndarray, List[int]]] = []
    for g in groups:
        idx = np.concatenate([np.arange(c * D, (c + 1) * D)
                              for c in g])
        sub = LdaEstimate(len(counts), len(idx))
        sub.counts = counts.copy()
        sub.first = first[:, idx]
        sub.total_second = second[np.ix_(idx, idx)]
        # estimate() appends a mean-offset column; keep the linear part
        mat = sub.estimate(len(idx), within_class_factor=po[
            "within-class-factor"])
        blocks.append((mat, list(idx)))
    out_dim = sum(b.shape[0] for b, _ in blocks)
    full = np.zeros((out_dim, total + 1), np.float64)
    r = 0
    for mat, idx in blocks:
        rows = slice(r, r + mat.shape[0])
        full[rows, -1] = mat[:, -1]            # offset column
        for j, col in enumerate(idx):
            full[rows, col] = mat[:, j]
        r += mat.shape[0]
    with kio.open_wxfilename(args[1]) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_matrix(f, full.astype(np.float32))
    log.info("nnet-get-feature-transform-multi: %d groups → "
             "%s block transform", len(groups), full.shape)
    return 0


@tool("nnet-modify-learning-rates")
def nnet_modify_learning_rates_tool(argv):
    """Set per-layer learning rates so every layer's RELATIVE
    parameter change (‖θ_cur − θ_prev‖/‖θ_cur‖) would match, with the
    geometric mean pinned to --average-learning-rate
    (nnet2bin/nnet-modify-learning-rates.cc).  The rates ride the
    model file; nnet-train-simple honors them."""
    from kaldi_tpu.am.nnet2 import layer_names, load_nnet2_full, \
        save_nnet2
    import dataclasses as _dc
    po = ParseOptions("nnet-modify-learning-rates [opts] "
                      "<prev-nnet2> <cur-nnet2> <nnet2-out>")
    po.register("average-learning-rate", float, 2e-3,
                "geometric-mean target of the per-layer rates")
    po.register("first-layer-factor", float, 1.0,
                "extra scale on layer 0's rate")
    po.register("last-layer-factor", float, 1.0,
                "extra scale on the output layer's rate")
    args = po.read(argv)
    prev, _pcfg, _ = load_nnet2_full(args[0])
    cur, cfg, priors = load_nnet2_full(args[1])
    names = layer_names(cfg)
    rel = []
    for name in names:
        dp, dc = 0.0, 0.0
        for leaf_p, leaf_c in zip(
                _flat_leaves(prev[name]), _flat_leaves(cur[name])):
            dp += float(((leaf_c - leaf_p) ** 2).sum())
            dc += float((leaf_c ** 2).sum())
        rel.append(np.sqrt(dp / max(dc, 1e-20)) + 1e-10)
    rel = np.asarray(rel)
    # lr_i ∝ 1/rel_i equalizes relative change; pin geometric mean
    inv = 1.0 / rel
    lrs = inv * po["average-learning-rate"] / np.exp(
        np.mean(np.log(inv)))
    lrs[0] *= po["first-layer-factor"]
    lrs[-1] *= po["last-layer-factor"]
    new_cfg = _dc.replace(cfg, learn_rates=tuple(float(x) for x in lrs))
    save_nnet2(args[2], cur, new_cfg, priors)
    for name, rc, lr in zip(names, rel, lrs):
        log.info("nnet-modify-learning-rates: %s rel-change %.3e "
                 "→ lr %.3e", name, rc, lr)
    return 0


def _flat_leaves(tree) -> List[np.ndarray]:
    import jax
    return [np.asarray(x, np.float64)
            for x in jax.tree_util.tree_leaves(dict(tree))]


@tool("nnet-normalize-stddev")
def nnet_normalize_stddev_tool(argv):
    """Rescale each hidden affine so its pre-pnorm output stddev over
    a set of egs equals --stddev (nnet2bin/nnet-normalize-stddev.cc).
    Valid because pnorm is scale-equivariant and the following
    NormalizeComponent cancels the scale downstream — only the layer's
    own dynamic range changes, exactly the reference's rationale."""
    import jax.numpy as jnp
    from kaldi_tpu.am.nnet2 import layer_names, load_nnet2_full, \
        save_nnet2
    from kaldi_tpu.am.nnet2 import normalize_rms, pnorm
    from kaldi_tpu.am.tdnn import splice
    po = ParseOptions("nnet-normalize-stddev [opts] <nnet2-in> "
                      "<egs-rspec> <nnet2-out>")
    po.register("stddev", float, 1.0, "target output stddev")
    args = po.read(argv)
    params, cfg, priors = load_nnet2_full(args[0])
    params = {k: {kk: {kkk: np.asarray(vvv) for kkk, vvv in
                       dict(vv).items()}
                  for kk, vv in dict(v).items()}
              if k != "output_affine" else
              {kk: np.asarray(vv) for kk, vv in dict(v).items()}
              for k, v in dict(params).items()}
    xs = []
    for _key, eg in SequentialTableReader(args[1], holder="xeg"):
        xs.append(np.asarray(eg.feats, np.float32))
    if not xs:
        raise KaldiError("nnet-normalize-stddev: no egs")
    h = np.concatenate(xs, axis=0)
    if h.shape[-1] == cfg.feat_dim and len(cfg.splice) > 1:
        h = np.asarray(splice(jnp.asarray(h[None]), cfg.splice))[0]
    hidden = layer_names(cfg)[:-1]
    for name in hidden:
        lay = params[name]["affine"]
        pre = h @ lay["kernel"] + lay["bias"]
        sd = float(pre.std())
        scale = po["stddev"] / max(sd, 1e-10)
        lay["kernel"] = (lay["kernel"] * scale).astype(np.float32)
        lay["bias"] = (lay["bias"] * scale).astype(np.float32)
        log.info("nnet-normalize-stddev: %s stddev %.3f → %.3f",
                 name, sd, po["stddev"])
        pre *= scale
        h = np.asarray(normalize_rms(pnorm(
            jnp.asarray(pre), cfg.pnorm_output_dim, cfg.p)))
    save_nnet2(args[2], params, cfg, priors)
    return 0


# ---------------------------------------------------------------------------
# nnet2 discriminative (sequence) training
# ---------------------------------------------------------------------------

def _train_discriminative(params, cfg, degs, criterion: str,
                          lr: float, kappa: float, epochs: int):
    """Shared core of nnet-train-discriminative-{simple,parallel}:
    per-eg adam steps on −objf over DiscEg records (feats + numerator
    pdf ali + dense denominator lattice), nnet2 model forward."""
    import jax
    import jax.numpy as jnp
    import optax
    from kaldi_tpu.am.discriminative import (DenseLattice,
                                             frame_accuracy, mmi_objf,
                                             smbr_objf)
    from kaldi_tpu.am.nnet2 import Nnet2Model
    model = Nnet2Model(cfg)
    tx = optax.adam(lr)
    opt = tx.init(params)

    def objf_fn(p, x, num, acc, lat):
        scores = model.apply({"params": p}, x[None])[0]
        if criterion == "mmi":
            return -mmi_objf(lat, scores, num, kappa)
        return -smbr_objf(lat, scores, acc, kappa)

    @jax.jit
    def step(p, o, x, num, acc, src, dst, pdfm, wt, mask, final):
        lat = DenseLattice(src=src, dst=dst, pdf=pdfm, w=wt,
                           mask=mask, final=final, num_states=None)
        loss, g = jax.value_and_grad(objf_fn)(p, x, num, acc, lat)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    tot, cnt = 0.0, 0
    for _ in range(epochs):
        for eg in degs:
            lat = DenseLattice(src=eg.src, dst=eg.dst, pdf=eg.pdf,
                               w=eg.w, mask=eg.mask, final=eg.final,
                               num_states=None)
            acc = (frame_accuracy(lat, np.asarray(eg.num_ali))
                   if criterion == "smbr" else
                   np.zeros_like(eg.w, np.float32))
            params, opt, loss = step(
                params, opt, jnp.asarray(eg.feats),
                jnp.asarray(eg.num_ali), jnp.asarray(acc),
                jnp.asarray(eg.src), jnp.asarray(eg.dst),
                jnp.asarray(eg.pdf), jnp.asarray(eg.w),
                jnp.asarray(eg.mask), jnp.asarray(eg.final))
            tot += float(loss)
            cnt += 1
    if cnt == 0:
        raise KaldiError("nnet2 discriminative training: no egs")
    return params, tot / cnt


@tool("nnet-train-discriminative-simple")
def nnet_train_discriminative_simple_tool(argv):
    """MMI/sMBR sequence training of an nnet2 model from
    discriminative egs (nnet2bin/nnet-train-discriminative-simple.cc).
    Degs are the same dense-lattice records the nnet3 pipeline uses
    (nnet3-discriminative-get-egs) — one example format, two model
    generations, matching the reference's shared degs philosophy."""
    from kaldi_tpu.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-train-discriminative-simple [opts] "
                      "<nnet2-in> <degs-rspec> <nnet2-out>")
    po.register("criterion", str, "smbr", "smbr|mmi")
    po.register("learning-rate", float, 5e-5, "adam lr")
    po.register("acoustic-scale", float, 0.1, "kappa")
    po.register("num-epochs", int, 2, "epochs over the egs")
    args = po.read(argv)
    if po["criterion"] not in ("smbr", "mmi"):
        raise KaldiError(f"unknown criterion {po['criterion']}")
    params, cfg, priors = load_nnet2_full(args[0])
    degs = [eg for _k, eg in SequentialTableReader(args[1],
                                                   holder="deg")]
    params, mean_loss = _train_discriminative(
        params, cfg, degs, po["criterion"], po["learning-rate"],
        po["acoustic-scale"], po["num-epochs"])
    save_nnet2(args[2], params, cfg, priors)
    log.info("nnet-train-discriminative-simple: %d egs, mean "
             "-objf %.4f", len(degs), mean_loss)
    return 0


@tool("nnet-train-discriminative-parallel")
def nnet_train_discriminative_parallel_tool(argv):
    """Parallel variant: the degs are sharded --num-threads ways, each
    shard trains a copy from the common start, and the result is the
    parameter average (nnet2bin/nnet-train-discriminative-parallel.cc
    — its threads update one model without locks; averaging shards
    is the deterministic equivalent of that race, and matches the
    recipe-level model-averaging contract)."""
    import jax
    from kaldi_tpu.am.nnet2 import load_nnet2_full, save_nnet2
    po = ParseOptions("nnet-train-discriminative-parallel [opts] "
                      "<nnet2-in> <degs-rspec> <nnet2-out>")
    po.register("criterion", str, "smbr", "smbr|mmi")
    po.register("learning-rate", float, 5e-5, "adam lr")
    po.register("acoustic-scale", float, 0.1, "kappa")
    po.register("num-epochs", int, 2, "epochs over the egs")
    po.register("num-threads", int, 2, "shards to train + average")
    args = po.read(argv)
    if po["criterion"] not in ("smbr", "mmi"):
        raise KaldiError(f"unknown criterion {po['criterion']}")
    params, cfg, priors = load_nnet2_full(args[0])
    degs = [eg for _k, eg in SequentialTableReader(args[1],
                                                   holder="deg")]
    N = max(1, min(po["num-threads"], len(degs)))
    shards = [degs[i::N] for i in range(N)]
    results = []
    loss = 0.0
    for shard in shards:
        p, l = _train_discriminative(
            params, cfg, shard, po["criterion"],
            po["learning-rate"], po["acoustic-scale"],
            po["num-epochs"])
        results.append(p)
        loss += l / N
    avg = jax.tree_util.tree_map(
        lambda *xs: sum(np.asarray(x, np.float64) for x in xs)
        .astype(np.float32) / len(xs), *results)
    save_nnet2(args[2], avg, cfg, priors)
    log.info("nnet-train-discriminative-parallel: %d egs over %d "
             "shards, mean -objf %.4f", len(degs), N, loss)
    return 0


# ---------------------------------------------------------------------------
# nnet3bin tail
# ---------------------------------------------------------------------------

@tool("nnet3-latgen-incremental")
def nnet3_latgen_incremental_tool(argv):
    """nnet3 lattice decoding with chunked advance and incrementally
    finalized lattices (nnet3bin/nnet3-latgen-incremental.cc): the
    TDNN scores the whole utterance in one matmul batch, then the online
    beam decoder consumes --chunk-frames at a time so decoder state
    stays bounded."""
    from kaldi_tpu.am.serialize import read_mdl
    from kaldi_tpu.cli.tools_bank3 import _load_tdnn
    from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu.decoder.online_beam import OnlineBeamDecoder
    from kaldi_tpu.fst.csr import pack_fst
    from kaldi_tpu.fst.fst import SymbolTable
    po = ParseOptions("nnet3-latgen-incremental [opts] <trans-model> "
                      "<raw-nnet3> <fst> <feats-rspec> <lat-wspec> "
                      "[<words-wspec>]")
    po.register("beam", float, 15.0, "decoding beam")
    po.register("lattice-beam", float, 8.0, "lattice beam")
    po.register("max-active", int, 7000, "max active states")
    po.register("acoustic-scale", float, 1.0, "acoustic scale")
    po.register("frame-subsampling-factor", int, 3, "subsampling")
    po.register("chunk-frames", int, 32, "decoder frames per advance")
    po.register("word-symbol-table", str, "", "words.txt")
    args = po.read(argv)
    tm, _ = read_mdl(args[0])
    _, fwd = _load_tdnn(args[1], po["frame-subsampling-factor"])
    cap = max(po["max-active"], 512)
    dec = BeamDecoder(pack_fst(_load_hclg(args[2])),
                      tm.tid_to_pdf_array,
                      BeamDecoderConfig(
                          beam=po["beam"],
                          lattice_beam=po["lattice-beam"],
                          acoustic_scale=po["acoustic-scale"],
                          max_active=po["max-active"],
                          lattice_arcs_per_frame=max(2 * cap, 4096),
                          record_capacity=16384))
    ob = OnlineBeamDecoder(dec, chunk_frames=po["chunk-frames"])
    words_tab = (SymbolTable.read(po["word-symbol-table"])
                 if po["word-symbol-table"] else None)
    ww = TableWriter(args[5], holder="text") if len(args) > 5 else None
    n = 0
    with TableWriter(args[4], holder="clat") as lw:
        for key, feats in SequentialTableReader(args[3], holder="mat"):
            scores = np.asarray(
                fwd(np.asarray(feats, np.float32)[None]))[0]
            ob.reset()
            C = po["chunk-frames"]
            for c in range(0, len(scores), C):
                ob.advance(scores[c:c + C])
            clat = ob.finalize()
            lw[key] = clat
            wseq, _, cost = clat.best_path()
            text = [words_tab.find(w) if words_tab else str(w)
                    for w in wseq]
            if ww:
                ww[key] = text
            log.info("%s: %s (cost %.2f)", key, " ".join(text), cost)
            n += 1
    if ww:
        ww.close()
    log.info("nnet3-latgen-incremental: %d utterances", n)
    return 0
