"""TDNN-F acoustic model (the nnet3 'chain' flagship architecture).

Parity target: the reference's nnet3 TDNN-F xconfig models
(egs/librispeech/s5/local/chain/tuning/run_tdnn_1d.sh:
tdnnf-layer with factorized semi-orthogonal bottlenecks, batchnorm,
ReLU, bypass connections, ×3 frame subsampling) — implemented in plain
JAX instead of rebuilding nnet3's computation compiler (SURVEY.md
§7.7: the Descriptor/Compiler machinery is an artifact of C++ graph
execution; XLA *is* the computation compiler here).

Time convolutions are dense matmuls over spliced frames; the
factorized layer is Linear(dim→bottleneck over [t−s, t]) followed by
Linear(bottleneck→dim over [t, t+s]) with an L2 semi-orthogonal
penalty on the first factor (the reference enforces semi-orthogonality
by periodic projection in nnet3; here it is a differentiable penalty
added to the training loss — same effect, idiomatic for optax).

The model objects keep the module contract the trainers call —
``init(rng, x, train=False)`` → ``{"params", "batch_stats"}`` and
``apply(variables, x, train=..., mutable=[...])`` — and the variable
tree the sharding rules, nnet3 converters and checkpoints address by
leaf name: ``input_affine``, ``tdnnf{i}/linear/kernel``,
``tdnnf{i}/affine/{kernel,bias}``, ``tdnnf{i}/batchnorm/{mean,var}``,
``input_bn``, ``prefinal``, ``prefinal_bn``, ``output_affine``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# batch-norm running-average momentum and variance floor (the values of
# the reference's BatchNormComponent defaults as used by the recipes)
BN_MOMENTUM = 0.99
BN_EPSILON = 1e-5


def splice(x: jnp.ndarray, offsets: Sequence[int]) -> jnp.ndarray:
    """(B, T, D) → (B, T, D*len(offsets)) taking frames at t+offset
    with edge clamping (nnet3 Offset/Append descriptor semantics).

    Implemented as ONE edge pad + static slices: a time shift is a
    view, not a T-row gather, so the slices fuse into the matmuls."""
    T = x.shape[1]
    lo = max(0, -min(offsets))
    hi = max(0, max(offsets))
    if lo or hi:
        xp = jnp.pad(x, ((0, 0), (lo, hi), (0, 0)), mode="edge")
    else:
        xp = x
    cols = [jax.lax.slice_in_dim(xp, lo + o, lo + o + T, axis=1)
            for o in offsets]
    return jnp.concatenate(cols, axis=-1)


def _dense_params(rng, fan_in: int, fan_out: int, bias: bool = True,
                  zero: bool = False) -> Dict[str, jnp.ndarray]:
    """{"kernel": (in, out), "bias": (out,)} — LeCun-normal kernel,
    zero bias (the initialisation the recipes' affine layers use)."""
    if zero:
        k = jnp.zeros((fan_in, fan_out), jnp.float32)
    else:
        k = jax.nn.initializers.lecun_normal()(rng, (fan_in, fan_out),
                                               jnp.float32)
    p = {"kernel": k}
    if bias:
        p["bias"] = jnp.zeros((fan_out,), jnp.float32)
    return p


def dense(p: Dict[str, jnp.ndarray], x: jnp.ndarray, dtype=None
          ) -> jnp.ndarray:
    """x @ kernel + bias.  ``dtype`` (e.g. bfloat16) casts operands and
    result; params stay float32.  Matmul precision follows
    ``jax.default_matmul_precision``."""
    k = p["kernel"]
    if dtype is not None:
        x = x.astype(dtype)
        k = k.astype(dtype)
    y = jnp.dot(x, k)
    if "bias" in p:
        y = y + p["bias"].astype(y.dtype)
    return y


def _bn_stats(dim: int) -> Dict[str, jnp.ndarray]:
    return {"mean": jnp.zeros((dim,), jnp.float32),
            "var": jnp.ones((dim,), jnp.float32)}


def batchnorm(stats: Dict[str, jnp.ndarray], x: jnp.ndarray, train: bool
              ) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Scale-free batch norm over every axis but the last.  Training
    normalizes by the batch statistics and returns the updated running
    averages; inference uses the running averages."""
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = jnp.mean(x, axis=axes)
        var = jnp.maximum(jnp.mean(x * x, axis=axes) - mean * mean, 0.0)
        new = {"mean": BN_MOMENTUM * stats["mean"]
               + (1.0 - BN_MOMENTUM) * mean,
               "var": BN_MOMENTUM * stats["var"]
               + (1.0 - BN_MOMENTUM) * var}
    else:
        mean, var, new = stats["mean"], stats["var"], stats
    return (x - mean) * jax.lax.rsqrt(var + BN_EPSILON), new


@dataclasses.dataclass(frozen=True)
class TdnnFLayer:
    """Factorized TDNN layer with bottleneck + bypass.

    `dtype` is the computation dtype for the matmuls (params and batch
    norm stay float32): bfloat16 runs the matmuls at the tensor cores'
    half-precision rate, the role of the reference's CUDA
    half-precision kernels."""
    dim: int
    bottleneck: int
    time_stride: int = 1            # context offset s
    bypass_scale: float = 0.66
    dtype: Any = None

    def _offsets(self):
        s = self.time_stride
        return ((-s, 0), (0, s)) if s else ((0,), (0,))

    def init(self, rng, in_dim: int):
        """→ (params, batch_stats) for an input of width in_dim."""
        o1, o2 = self._offsets()
        k1, k2 = jax.random.split(rng)
        params = {
            "linear": _dense_params(k1, in_dim * len(o1), self.bottleneck,
                                    bias=False),
            "affine": _dense_params(k2, self.bottleneck * len(o2),
                                    self.dim),
        }
        return params, {"batchnorm": _bn_stats(self.dim)}

    def __call__(self, params, stats, x, train: bool = False):
        o1, o2 = self._offsets()
        # factor 1: constrained (semi-orthogonal), context [t-s, t]
        h = dense(params["linear"], splice(x, o1), self.dtype)
        # factor 2: context [t, t+s]
        h = dense(params["affine"], splice(h, o2), self.dtype)
        h = jax.nn.relu(h).astype(jnp.float32)
        h, bn = batchnorm(stats["batchnorm"], h, train)
        if x.shape[-1] == self.dim:
            h = h + self.bypass_scale * x
        return h, {"batchnorm": bn}


@dataclasses.dataclass
class TdnnConfig:
    feat_dim: int = 40
    num_pdfs: int = 128
    hidden_dim: int = 512
    bottleneck_dim: int = 128
    num_layers: int = 9
    frame_subsampling_factor: int = 3
    # per-layer time strides: early layers short, later dilated (1d recipe)
    strides: Optional[Sequence[int]] = None
    # "bfloat16" runs the matmuls in half precision (params and
    # batchnorm stay f32); "float32" is the default/reference-accuracy
    compute_dtype: str = "float32"

    def layer_strides(self) -> Sequence[int]:
        if self.strides is not None:
            return self.strides
        return [1, 1, 1] + [3] * (self.num_layers - 3)


class TdnnChain:
    """Input (B, T, feat_dim) → output (B, T//sub, num_pdfs) log-space
    scores (chain models use un-normalized outputs; the denominator
    normalizes)."""

    def __init__(self, config: TdnnConfig):
        self.config = config

    def _dtype(self):
        return (jnp.bfloat16 if self.config.compute_dtype == "bfloat16"
                else None)

    def _layers(self):
        cfg = self.config
        return [TdnnFLayer(cfg.hidden_dim, cfg.bottleneck_dim,
                           time_stride=s, dtype=self._dtype())
                for s in cfg.layer_strides()]

    def init(self, rng, x, train: bool = False):
        """Variables for inputs shaped like x (only its last axis is
        read).  The output layer starts at zero, as in the recipes."""
        del train
        cfg = self.config
        H = cfg.hidden_dim
        layers = self._layers()
        keys = jax.random.split(rng, len(layers) + 2)
        params = {"input_affine": _dense_params(keys[0],
                                                3 * x.shape[-1], H)}
        stats = {"input_bn": _bn_stats(H)}
        for i, (layer, k) in enumerate(zip(layers, keys[2:])):
            params[f"tdnnf{i + 1}"], stats[f"tdnnf{i + 1}"] = \
                layer.init(k, H)
        params["prefinal"] = _dense_params(keys[1], H, H)
        stats["prefinal_bn"] = _bn_stats(H)
        params["output_affine"] = _dense_params(None, H, cfg.num_pdfs,
                                                zero=True)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables, x, train: bool = False, mutable=(),
              rngs=None):
        """Forward pass.  With ``mutable`` naming "batch_stats" (the
        training contract) returns (scores, {"batch_stats": updated})."""
        del rngs
        cfg = self.config
        p, s = variables["params"], variables["batch_stats"]
        dt = self._dtype()
        new = {}
        # input splice ±1 (the lda-ish input context of the 1d recipe)
        h = dense(p["input_affine"], splice(x, (-1, 0, 1)), dt)
        h = jax.nn.relu(h).astype(jnp.float32)
        h, new["input_bn"] = batchnorm(s["input_bn"], h, train)
        for i, layer in enumerate(self._layers()):
            name = f"tdnnf{i + 1}"
            h, new[name] = layer(p[name], s[name], h, train)
        # frame subsampling: take every k-th frame before the output layers
        k = cfg.frame_subsampling_factor
        if k > 1:
            h = h[:, ::k, :]
        h = dense(p["prefinal"], h, dt)
        h = jax.nn.relu(h).astype(jnp.float32)
        h, new["prefinal_bn"] = batchnorm(s["prefinal_bn"], h, train)
        out = dense(p["output_affine"], h)
        if mutable:
            return out, {"batch_stats": new}
        return out


def forward_numpy(config: TdnnConfig, variables, x: np.ndarray,
                  train: bool = False):
    """Float64 NumPy forward of TdnnChain — the plain reference the
    JAX model is checked against.  Returns (scores, batch_stats); the
    stats are the updated running averages when ``train``."""
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               variables["params"])
    s = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                               variables["batch_stats"])
    x = np.asarray(x, np.float64)

    def spl(a, offs):
        T = a.shape[1]
        idx = [np.clip(np.arange(T) + o, 0, T - 1) for o in offs]
        return np.concatenate([a[:, i] for i in idx], axis=-1)

    def aff(q, a):
        return a @ q["kernel"] + q.get("bias", 0.0)

    def bn(st, a):
        if train:
            m = a.mean(axis=(0, 1))
            v = a.var(axis=(0, 1))
            st = {"mean": BN_MOMENTUM * st["mean"] + (1 - BN_MOMENTUM) * m,
                  "var": BN_MOMENTUM * st["var"] + (1 - BN_MOMENTUM) * v}
        else:
            m, v = st["mean"], st["var"]
        return (a - m) / np.sqrt(v + BN_EPSILON), st

    new = {}
    h = np.maximum(aff(p["input_affine"], spl(x, (-1, 0, 1))), 0.0)
    h, new["input_bn"] = bn(s["input_bn"], h)
    for i, st in enumerate(config.layer_strides()):
        name = f"tdnnf{i + 1}"
        o1, o2 = ((-st, 0), (0, st)) if st else ((0,), (0,))
        y = aff(p[name]["linear"], spl(h, o1))
        y = np.maximum(aff(p[name]["affine"], spl(y, o2)), 0.0)
        y, bs = bn(s[name]["batchnorm"], y)
        new[name] = {"batchnorm": bs}
        h = y + 0.66 * h if h.shape[-1] == config.hidden_dim else y
    h = h[:, ::config.frame_subsampling_factor]
    h = np.maximum(aff(p["prefinal"], h), 0.0)
    h, new["prefinal_bn"] = bn(s["prefinal_bn"], h)
    return aff(p["output_affine"], h), new


def semi_orthogonal_penalty(params) -> jnp.ndarray:
    """Σ ‖MMᵀ − scale·I‖² over every TDNN-F first factor
    (nnet-utils.cc ConstrainOrthonormal's floating-scale objective)."""
    total = 0.0
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, leaf in flat:
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        if "linear" in names and names[-1] == "kernel":
            m = leaf.T  # (bottleneck, in)
            p = m @ m.T
            scale = jnp.trace(p) / p.shape[0]
            total = total + jnp.sum((p - scale * jnp.eye(p.shape[0])) ** 2)
    return total
