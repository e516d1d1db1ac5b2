"""nnet2-era acoustic models: p-norm networks + parallel SGD with
model averaging.

Parity target: src/nnet2/ ("Dan's" first NN framework).  Its two
distinguishing pieces, re-expressed as batched device programs:

- **p-norm nonlinearity** (`PnormComponent` + `NormalizeComponent`,
  src/nnet2/nnet-component.h): dimension reduction by grouped p-norms
  y_j = (Σ_{i∈group j} |x_i|^p)^{1/p} (p = 2 in every shipped recipe)
  followed by renormalization to RMS 1.  Both are pure elementwise/
  reduction ops that XLA fuses into the surrounding matmuls.
- **parallel SGD with periodic model averaging**
  (`steps/nnet2/train_pnorm_fast.sh` + nnet-am-average): N jobs train
  on disjoint data shards from a common start, and the iteration's
  model is the parameter average.  This framework's primary
  data-parallel path is synchronous psum-gradient SGD (pipelines/
  chain.py) — `train_parallel_averaging` reproduces the reference's
  averaging SEMANTICS for parity experiments, with each "job" a batch
  shard and the average taken every `iter_batches` steps.

The preconditioned-affine piece of nnet2 (OnlinePreconditioner) is the
same algorithm as nnet3's natural gradient — provided by
ops/natural_gradient.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import get_logger

log = get_logger(__name__)


def pnorm(x: jnp.ndarray, output_dim: int, p: float = 2.0) -> jnp.ndarray:
    """Grouped p-norm: input dim must be a multiple of output_dim;
    each output pools group_size consecutive inputs."""
    D = x.shape[-1]
    if D % output_dim:
        raise ValueError(f"pnorm: input dim {D} not a multiple of "
                         f"output dim {output_dim}")
    g = D // output_dim
    xg = x.reshape(x.shape[:-1] + (output_dim, g))
    if p == 2.0:
        return jnp.sqrt(jnp.sum(xg * xg, axis=-1) + 1e-20)
    return jnp.power(jnp.sum(jnp.power(jnp.abs(xg), p), axis=-1) + 1e-20,
                     1.0 / p)


def normalize_rms(x: jnp.ndarray, target_rms: float = 1.0) -> jnp.ndarray:
    """NormalizeComponent: scale each frame so its root-mean-square is
    target_rms (the reference's scale = target_rms·√D / ‖x‖)."""
    D = x.shape[-1]
    norm = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-20)
    return x * (target_rms * jnp.sqrt(float(D)) / norm)


class PnormLayer(nn.Module):
    """Affine → pnorm → normalize (one hidden layer of the
    train_pnorm_fast.sh architecture)."""
    pnorm_input_dim: int
    pnorm_output_dim: int
    p: float = 2.0

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.pnorm_input_dim, name="affine")(x)
        h = pnorm(h, self.pnorm_output_dim, self.p)
        return normalize_rms(h)


@dataclasses.dataclass
class Nnet2Config:
    feat_dim: int = 40
    num_pdfs: int = 128
    num_hidden_layers: int = 3
    pnorm_input_dim: int = 800
    pnorm_output_dim: int = 160
    splice: Tuple[int, ...] = (-2, -1, 0, 1, 2)
    p: float = 2.0
    # "mixed-up" softmax (SoftmaxComponent::MixUp,
    # src/nnet2/nnet-component.h): the output affine has
    # len(mix2pdf) >= num_pdfs rows; posteriors of rows mapped to the
    # same pdf are summed (log-domain: grouped logsumexp of logits)
    mix2pdf: Optional[Tuple[int, ...]] = None
    # nnet-am-switch-preconditioning flag: trainers consult this to
    # use the NG-SGD preconditioner (ops/natural_gradient.py) instead
    # of plain SGD
    preconditioned: bool = False
    # per-layer learning rates (hidden layers then output affine), set
    # by nnet-modify-learning-rates (src/nnet2/nnet-nnet.h
    # SetLearningRates role); trainers scale each layer's update by
    # learn_rates[i] / base_lr when present
    learn_rates: Optional[Tuple[float, ...]] = None


class Nnet2Model(nn.Module):
    """(B, T, feat_dim) → (B, T, num_pdfs) log-softmax posteriors."""
    config: Nnet2Config

    @nn.compact
    def __call__(self, x):
        from kaldi_tpu.am.tdnn import splice
        cfg = self.config
        # egs carry pre-spliced windows (nnet-get-egs does the
        # splicing, the upstream contract) — detect by dim and skip
        # the model-side splice then
        if x.shape[-1] == cfg.feat_dim * len(cfg.splice) \
                and len(cfg.splice) > 1:
            h = x
        else:
            h = splice(x, cfg.splice)
        for i in range(cfg.num_hidden_layers):
            h = PnormLayer(cfg.pnorm_input_dim, cfg.pnorm_output_dim,
                           cfg.p, name=f"pnorm{i + 1}")(h)
        if cfg.mix2pdf is not None:
            h = nn.Dense(len(cfg.mix2pdf), name="output_affine")(h)
            # grouped logsumexp over mixture rows per pdf, max-shifted
            onehot = jnp.asarray(
                np.eye(cfg.num_pdfs, dtype=np.float32)[
                    np.asarray(cfg.mix2pdf)])
            mx = jnp.max(h, axis=-1, keepdims=True)
            h = jnp.log(jnp.maximum(
                jnp.exp(h - mx) @ onehot, 1e-30)) + mx
        else:
            h = nn.Dense(cfg.num_pdfs, name="output_affine")(h)
        return nn.log_softmax(h, axis=-1)


def train_parallel_averaging(cfg: Nnet2Config,
                             feats: np.ndarray, targets: np.ndarray,
                             num_jobs: int = 4, num_iters: int = 10,
                             learning_rate: float = 2e-3,
                             seed: int = 0) -> Tuple[Dict, Dict[str, float]]:
    """The nnet2 outer loop: each iteration, `num_jobs` SGD workers
    start from the SAME parameters, each takes one pass over its own
    data shard, and the next iteration starts from the parameter
    average (nnet-am-average).  feats (N, T, D), targets (N, T) int32.

    Returns (params, diagnostics).  Jobs are vmapped over a leading
    jobs axis — N independent SGD trajectories advance as one XLA
    program per step, the single-program reading of run.pl's N processes."""
    import optax
    model = Nnet2Model(cfg)
    rng = jax.random.PRNGKey(seed)
    params = model.init(rng, jnp.zeros((1, 4, cfg.feat_dim)))["params"]
    tx = optax.sgd(learning_rate)

    N = feats.shape[0]
    if N % num_jobs:
        keep = N - (N % num_jobs)
        feats, targets = feats[:keep], targets[:keep]
    fshard = jnp.asarray(feats.reshape(num_jobs, -1, *feats.shape[1:]))
    tshard = jnp.asarray(targets.reshape(num_jobs, -1,
                                         *targets.shape[1:]))

    def xent(p, f, t):
        logp = model.apply({"params": p}, f)
        ll = jnp.take_along_axis(logp, t[..., None], axis=-1)
        return -jnp.mean(ll)

    def job_pass(p, f, t):
        """One worker's pass over its shard (minibatch = 8 chunks)."""
        opt = tx.init(p)
        nb = max(f.shape[0] // 8, 1)

        def step(carry, i):
            p, opt = carry
            fb = jax.lax.dynamic_slice_in_dim(f, i * 8, 8, 0)
            tb = jax.lax.dynamic_slice_in_dim(t, i * 8, 8, 0)
            loss, g = jax.value_and_grad(xent)(p, fb, tb)
            up, opt = tx.update(g, opt, p)
            return (optax.apply_updates(p, up), opt), loss

        (p, _), losses = jax.lax.scan(step, (p, opt), jnp.arange(nb))
        return p, losses.mean()

    @jax.jit
    def one_iter(p):
        bc = jax.tree_util.tree_map(
            lambda v: jnp.broadcast_to(v, (num_jobs,) + v.shape), p)
        jp, jl = jax.vmap(job_pass)(bc, fshard, tshard)
        avg = jax.tree_util.tree_map(lambda v: v.mean(axis=0), jp)
        return avg, jl.mean()

    loss = None
    for it in range(num_iters):
        params, loss = one_iter(params)
        log.info("nnet2 iter %d: %d jobs averaged, xent %.4f", it,
                 num_jobs, float(loss))
    return params, {"xent": float(loss)}


def layer_names(cfg: Nnet2Config) -> Tuple[str, ...]:
    """Ordered top-level param-tree keys: hidden layers then output."""
    return tuple(f"pnorm{i + 1}" for i in range(cfg.num_hidden_layers)) \
        + ("output_affine",)


def scale_updates_per_layer(updates: Dict, cfg: Nnet2Config,
                            base_lr: float) -> Dict:
    """Apply cfg.learn_rates (nnet-modify-learning-rates output) to an
    optimizer update tree computed with a uniform base_lr."""
    if cfg.learn_rates is None:
        return updates
    names = layer_names(cfg)
    scale = {n: float(cfg.learn_rates[i]) / base_lr
             for i, n in enumerate(names) if i < len(cfg.learn_rates)}
    return {k: jax.tree_util.tree_map(
        lambda u, s=scale.get(k, 1.0): u * s, v)
        for k, v in updates.items()}


def save_nnet2(path: str, params: Dict, cfg: Nnet2Config,
               priors: Optional[np.ndarray] = None) -> None:
    """Serialize an Nnet2Model (the nnet2 final.mdl raw-net part).
    `priors` is the AmNnet prior vector (src/nnet2/am-nnet.h) used to
    turn posteriors into pseudo-loglikelihoods at decode time."""
    from kaldi_tpu.am.serialize import write_pytree
    from kaldi_tpu.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<Nnet2>")
        for v in (cfg.feat_dim, cfg.num_pdfs, cfg.num_hidden_layers,
                  cfg.pnorm_input_dim, cfg.pnorm_output_dim):
            kio.write_basic_int32(f, int(v))
        kio.write_basic_float(f, float(cfg.p))
        kio.write_int_vector(f, np.asarray(cfg.splice, np.int32))
        kio.write_token(f, "<Params>")
        import jax
        write_pytree(f, jax.tree_util.tree_map(np.asarray,
                                               dict(params)))
        if cfg.mix2pdf is not None:
            kio.write_token(f, "<Mix2Pdf>")
            kio.write_int_vector(f, np.asarray(cfg.mix2pdf, np.int32))
        if cfg.preconditioned:
            kio.write_token(f, "<Preconditioned>")
        if cfg.learn_rates is not None:
            kio.write_token(f, "<LearnRates>")
            kio.write_vector(f, np.asarray(cfg.learn_rates, np.float32))
        if priors is not None:
            kio.write_token(f, "<Priors>")
            kio.write_vector(f, np.asarray(priors, np.float32))
        kio.write_token(f, "</Nnet2>")


def load_nnet2_full(path: str):
    """→ (params, Nnet2Config, priors-or-None)."""
    from kaldi_tpu.am.serialize import read_pytree
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<Nnet2>")
        feat_dim = kio.read_basic_int32(f)
        num_pdfs = kio.read_basic_int32(f)
        nh = kio.read_basic_int32(f)
        pin = kio.read_basic_int32(f)
        pout = kio.read_basic_int32(f)
        p = kio.read_basic_float(f)
        splice = tuple(int(x) for x in kio.read_int_vector(f))
        kio.expect_token(f, "<Params>")
        params = read_pytree(f)
        mix2pdf = None
        precond = False
        priors = None
        learn_rates = None
        while True:
            tok = kio.read_token(f)
            if tok == "</Nnet2>":
                break
            if tok == "<Mix2Pdf>":
                mix2pdf = tuple(int(x) for x in kio.read_int_vector(f))
            elif tok == "<Preconditioned>":
                precond = True
            elif tok == "<LearnRates>":
                learn_rates = tuple(float(x) for x in kio.read_vector(f))
            elif tok == "<Priors>":
                priors = kio.read_vector(f)
            else:
                raise ValueError(f"load_nnet2: unexpected token {tok}")
    cfg = Nnet2Config(feat_dim=feat_dim, num_pdfs=num_pdfs,
                      num_hidden_layers=nh, pnorm_input_dim=pin,
                      pnorm_output_dim=pout, splice=splice, p=p,
                      mix2pdf=mix2pdf, preconditioned=precond,
                      learn_rates=learn_rates)
    return params, cfg, priors


def load_nnet2(path: str):
    """→ (params, Nnet2Config).  See load_nnet2_full for priors."""
    params, cfg, _priors = load_nnet2_full(path)
    return params, cfg
