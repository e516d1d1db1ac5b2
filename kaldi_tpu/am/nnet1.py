"""nnet1-era acoustic models: RBM pretraining + sigmoid DNN.

Parity target: src/nnet/ ("Karel's" DNN).  Its distinguishing recipe
(steps/nnet/pretrain_dbn.sh + train.sh): stack restricted Boltzmann
machines trained layerwise by contrastive divergence (CD-1), then
fine-tune the unrolled sigmoid DNN with frame cross-entropy (and sMBR
sequence training — provided by am/discriminative.py here).

Design: CD-1 is three dense matmuls + elementwise sampling per
minibatch — one jitted update over the whole batch; layerwise
pretraining is a Python loop over layers, each layer's forward pass
materialized once (B, T, D) for the next.
- First layer: Gaussian-Bernoulli RBM (real-valued inputs, unit
  variance assumed — inputs are globally CMVN'd, as in the recipe).
- Deeper layers: Bernoulli-Bernoulli on the previous layer's hidden
  probabilities.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)


@dataclasses.dataclass
class RbmParams:
    W: np.ndarray        # (vis, hid)
    vis_bias: np.ndarray
    hid_bias: np.ndarray
    gaussian_visible: bool = False


def cd1_update(rbm: Dict[str, jnp.ndarray], v0: jnp.ndarray,
               key, lr: float, gaussian_visible: bool
               ) -> Tuple[Dict[str, jnp.ndarray], jnp.ndarray]:
    """One CD-1 step on a (B, vis) minibatch.  Returns (new params,
    reconstruction MSE).  Hidden states are sampled for the down pass
    (rbm-train-cd1-frmshuff semantics); statistics use probabilities."""
    W, vb, hb = rbm["W"], rbm["vis_bias"], rbm["hid_bias"]
    h0_prob = jax.nn.sigmoid(v0 @ W + hb)
    h0_samp = (jax.random.uniform(key, h0_prob.shape)
               < h0_prob).astype(v0.dtype)
    if gaussian_visible:
        v1 = h0_samp @ W.T + vb          # mean-field real visible
    else:
        v1 = jax.nn.sigmoid(h0_samp @ W.T + vb)
    h1_prob = jax.nn.sigmoid(v1 @ W + hb)
    B = v0.shape[0]
    dW = (v0.T @ h0_prob - v1.T @ h1_prob) / B
    dvb = jnp.mean(v0 - v1, axis=0)
    dhb = jnp.mean(h0_prob - h1_prob, axis=0)
    new = {"W": W + lr * dW, "vis_bias": vb + lr * dvb,
           "hid_bias": hb + lr * dhb}
    return new, jnp.mean((v0 - v1) ** 2)


def train_rbm(data: np.ndarray, hid_dim: int, num_epochs: int = 4,
              batch_size: int = 256, lr: float = 0.05,
              gaussian_visible: bool = False, seed: int = 0
              ) -> Tuple[RbmParams, List[float]]:
    """Train one RBM on (N, vis) frames; returns params + per-epoch
    reconstruction errors (monotone decrease is the health check)."""
    rng = np.random.default_rng(seed)
    vis = data.shape[1]
    rbm = {"W": jnp.asarray(
        rng.standard_normal((vis, hid_dim)) * 0.01, jnp.float32),
        "vis_bias": jnp.zeros(vis, jnp.float32),
        "hid_bias": jnp.zeros(hid_dim, jnp.float32)}
    step = jax.jit(lambda r, v, k: cd1_update(r, v, k, lr,
                                              gaussian_visible))
    key = jax.random.PRNGKey(seed)
    errs = []
    for ep in range(num_epochs):
        order = rng.permutation(len(data))
        tot, nb = 0.0, 0
        for i in range(0, len(data) - batch_size + 1, batch_size):
            v = jnp.asarray(data[order[i:i + batch_size]], jnp.float32)
            key, sub = jax.random.split(key)
            rbm, err = step(rbm, v, sub)
            tot += float(err)
            nb += 1
        errs.append(tot / max(nb, 1))
        log.info("rbm: epoch %d recon mse %.4f", ep, errs[-1])
    return RbmParams(np.asarray(rbm["W"]), np.asarray(rbm["vis_bias"]),
                     np.asarray(rbm["hid_bias"]),
                     gaussian_visible=gaussian_visible), errs


def pretrain_dbn(frames: np.ndarray, hid_dims: Sequence[int],
                 num_epochs: int = 4, seed: int = 0) -> List[RbmParams]:
    """steps/nnet/pretrain_dbn.sh: layerwise CD-1 stack.  frames is
    (N, feat_dim) spliced+normalized input."""
    rbms: List[RbmParams] = []
    h = frames.astype(np.float32)
    for li, hd in enumerate(hid_dims):
        rbm, _ = train_rbm(h, hd, num_epochs=num_epochs,
                           gaussian_visible=(li == 0), seed=seed + li)
        rbms.append(rbm)
        h = np.asarray(jax.nn.sigmoid(
            jnp.asarray(h) @ rbm.W + rbm.hid_bias))
        log.info("dbn: layer %d pretrained (%d → %d)", li + 1,
                 rbm.W.shape[0], hd)
    return rbms


class SigmoidDnn(nn.Module):
    """The unrolled DBN + output layer: (B, T, D) → log-posteriors."""
    hid_dims: Tuple[int, ...]
    num_pdfs: int

    @nn.compact
    def __call__(self, x):
        h = x
        for i, hd in enumerate(self.hid_dims):
            h = nn.Dense(hd, name=f"hidden{i + 1}")(h)
            h = nn.sigmoid(h)
        h = nn.Dense(self.num_pdfs, name="output_affine")(h)
        return nn.log_softmax(h, axis=-1)


def dnn_params_from_dbn(rbms: Sequence[RbmParams], num_pdfs: int,
                        seed: int = 0) -> Dict:
    """Initialize SigmoidDnn params from the pretrained stack (the
    dbn → nnet init of steps/nnet/train.sh)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, r in enumerate(rbms):
        params[f"hidden{i + 1}"] = {
            "kernel": jnp.asarray(r.W),
            "bias": jnp.asarray(r.hid_bias)}
    out_in = rbms[-1].W.shape[1]
    params["output_affine"] = {
        "kernel": jnp.asarray(
            rng.standard_normal((out_in, num_pdfs)) * 0.01, jnp.float32),
        "bias": jnp.zeros(num_pdfs, jnp.float32)}
    return params


def finetune_xent(params: Dict, hid_dims: Sequence[int], num_pdfs: int,
                  frames: np.ndarray, targets: np.ndarray,
                  num_epochs: int = 6, batch_size: int = 256,
                  lr: float = 0.5, seed: int = 0,
                  lr_factors: Optional[Dict[str, float]] = None
                  ) -> Tuple[Dict, float]:
    """Frame cross-entropy fine-tuning (nnet-train-frmshuff): plain
    SGD on shuffled frames, the nnet1 default.  ``lr_factors`` maps
    top-level layer names to per-layer learning-rate multipliers
    (the nnet-set-learnrate contract); factor 0 freezes a layer."""
    import optax
    model = SigmoidDnn(tuple(hid_dims), num_pdfs)
    tx = optax.sgd(lr)
    opt = tx.init(params)

    @jax.jit
    def step(p, o, f, t):
        def loss_fn(p):
            logp = model.apply({"params": p}, f[:, None, :])[:, 0]
            return -jnp.mean(jnp.take_along_axis(
                logp, t[:, None], axis=-1))
        loss, g = jax.value_and_grad(loss_fn)(p)
        if lr_factors:
            g = {k: jax.tree_util.tree_map(
                lambda x: x * float(lr_factors.get(k, 1.0)), v)
                for k, v in g.items()}
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), o, loss

    rng = np.random.default_rng(seed)
    batch_size = max(1, min(batch_size, len(frames)))
    loss = None
    for ep in range(num_epochs):
        order = rng.permutation(len(frames))
        tot, nb = 0.0, 0
        for i in range(0, len(frames) - batch_size + 1, batch_size):
            idx = order[i:i + batch_size]
            params, opt, loss = step(
                params, opt, jnp.asarray(frames[idx], jnp.float32),
                jnp.asarray(targets[idx], jnp.int32))
            tot += float(loss)
            nb += 1
        log.info("nnet1: epoch %d xent %.4f", ep, tot / max(nb, 1))
    return params, float(loss)


def save_nnet1(path: str, params: Dict, hid_dims: Sequence[int],
               num_pdfs: int,
               priors: Optional[np.ndarray] = None,
               lr_factors: Optional[np.ndarray] = None) -> None:
    """Serialize a SigmoidDnn (the nnet1 final.nnet role): dims +
    params (+ optional class priors for nnet-forward's
    --class-frame-counts division; + optional per-layer learning-rate
    factors for [hidden1..hiddenN, output_affine] — the
    nnet-set-learnrate contract)."""
    from kaldi_tpu.am.serialize import write_pytree
    from kaldi_tpu.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<Nnet1>")
        kio.write_basic_int32(f, len(hid_dims))
        for hd in hid_dims:
            kio.write_basic_int32(f, int(hd))
        kio.write_basic_int32(f, int(num_pdfs))
        kio.write_basic_int32(f, 1 if priors is not None else 0)
        if priors is not None:
            kio.write_vector(f, np.asarray(priors, np.float32))
        kio.write_token(f, "<Params>")
        import jax
        write_pytree(f, jax.tree_util.tree_map(np.asarray,
                                               dict(params)))
        if lr_factors is not None:
            kio.write_token(f, "<LrFactors>")
            kio.write_vector(f, np.asarray(lr_factors, np.float32))
        kio.write_token(f, "</Nnet1>")


def load_nnet1(path: str):
    """→ (params, hid_dims, num_pdfs, priors-or-None).  See
    load_nnet1_full for the learning-rate factors."""
    params, hid_dims, num_pdfs, priors, _lr = load_nnet1_full(path)
    return params, hid_dims, num_pdfs, priors


def load_nnet1_full(path: str):
    """→ (params, hid_dims, num_pdfs, priors, lr_factors)."""
    from kaldi_tpu.am.serialize import read_pytree
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<Nnet1>")
        n = kio.read_basic_int32(f)
        hid_dims = tuple(kio.read_basic_int32(f) for _ in range(n))
        num_pdfs = kio.read_basic_int32(f)
        priors = (np.asarray(kio.read_vector(f))
                  if kio.read_basic_int32(f) else None)
        kio.expect_token(f, "<Params>")
        params = read_pytree(f)
        lr_factors = None
        tok = kio.read_token(f)
        if tok == "<LrFactors>":
            lr_factors = np.asarray(kio.read_vector(f))
            tok = kio.read_token(f)
        if tok != "</Nnet1>":
            raise KaldiError(f"load_nnet1: unexpected token {tok}")
    return params, hid_dims, num_pdfs, priors, lr_factors
