"""xconfig: the nnet3 network-configuration language.

Parity target: egs/wsj/s5/steps/nnet3/xconfig_to_configs.py and
steps/libs/nnet3/xconfig/ — the layer-line language every nnet3 recipe
writes its model in (`relu-batchnorm-layer`, `tdnnf-layer`,
`fast-lstmp-layer`, `attention-relu-batchnorm-layer`, `stats-layer`,
`output-layer`) with Descriptor inputs (`Append(-1,0,1)`,
`Offset(tdnn1, -3)`, layer-name references).

Redesign: the reference compiles xconfig → config →
nnet3 computation graph executed by NnetComputer.  Here the parsed
line list IS the model — `XconfigModel` is a flax module that
interprets the lines at trace time, reusing the native layer
implementations (TdnnFLayer, RestrictedAttentionLayer, LstmpLayer,
StatisticsPooling); XLA replaces the nnet3 compiler (SURVEY.md §7.7).
Descriptors become splice/concat of cached layer outputs — everything
stays a dense (B, T, D) tensor pipeline for the matrix units.

Supported grammar (one layer per line, `#` comments):
    input name=<n> dim=<d>
    relu-batchnorm-layer name=<n> [input=<desc>] dim=<d>
    relu-renorm-layer        (renorm ≈ batchnorm here, noted)
    tdnnf-layer name=<n> dim=<d> bottleneck-dim=<b> time-stride=<s>
                [dropout-proportion=<p>] [bypass-scale=<f>]
    fast-lstmp-layer name=<n> cell-dim=<c> recurrent-projection-dim=<p>
    attention-relu-batchnorm-layer name=<n> dim=<d> num-heads=<h>
                num-left-inputs=<l> num-right-inputs=<r>
    stats-layer name=<n> config=mean+stddev(<l>:<.>:<.>:<r>)
    conv-relu-batchnorm-layer name=<n> height-in=<h> num-filters-out=<f>
                [time-offsets=-1,0,1] [height-offsets=-1,0,1]
                [height-subsample-out=<s>]
    output-layer name=<n> [input=<desc>] dim=<d>
                [include-log-softmax=true|false]
Descriptors: layer name | integer offset of the default input |
    Offset(<name>, <k>) | Append(<item>, ...) of the above.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.am.tdnn import splice
from kaldi_tpu.am.lstm import LstmpLayer
from kaldi_tpu.am.xvector import StatisticsPooling

log = get_logger(__name__)


class TdnnFLayer(nn.Module):
    """Factorized TDNN layer with bottleneck + bypass, as a flax module
    for the xconfig interpreter (same computation and leaf names as
    am/tdnn.TdnnFLayer, plus dropout)."""
    dim: int
    bottleneck: int
    time_stride: int = 1            # context offset s
    bypass_scale: float = 0.66
    dropout: float = 0.0
    dtype: Any = None

    @nn.compact
    def __call__(self, x, train: bool = False):
        # factor 1: constrained (semi-orthogonal), context [t-s, t]
        h = splice(x, (-self.time_stride, 0) if self.time_stride else (0,))
        h = nn.Dense(self.bottleneck, use_bias=False, name="linear",
                     dtype=self.dtype)(h)
        # factor 2: context [t, t+s]
        h = splice(h, (0, self.time_stride) if self.time_stride else (0,))
        h = nn.Dense(self.dim, name="affine", dtype=self.dtype)(h)
        h = nn.relu(h)
        h = h.astype(jnp.float32)
        h = nn.BatchNorm(use_running_average=not train, use_bias=False,
                         use_scale=False, name="batchnorm")(h)
        if self.dropout > 0.0 and train:
            h = nn.Dropout(self.dropout, deterministic=not train)(h)
        if x.shape[-1] == self.dim:
            h = h + self.bypass_scale * x
        return h


class RestrictedAttentionLayer(nn.Module):
    """Time-restricted self-attention (nnet-attention-component.h
    RestrictedAttentionComponent): each frame attends to
    [t − left_ctx, t + right_ctx] only — a banded attention mask, which
    keeps the QKᵀ matmul dense while bounding the receptive field like
    the reference."""
    dim: int
    num_heads: int = 4
    left_ctx: int = 9
    right_ctx: int = 9
    bypass_scale: float = 0.66

    @nn.compact
    def __call__(self, x, train: bool = False):
        B, T, D = x.shape
        H = self.num_heads
        dh = self.dim // H
        q = nn.Dense(H * dh, name="query")(x).reshape(B, T, H, dh)
        k = nn.Dense(H * dh, name="key")(x).reshape(B, T, H, dh)
        v = nn.Dense(H * dh, name="value")(x).reshape(B, T, H, dh)
        logits = jnp.einsum("bthd,bshd->bhts", q, k) / jnp.sqrt(dh)
        ti = jnp.arange(T)[:, None]
        si = jnp.arange(T)[None, :]
        band = (si >= ti - self.left_ctx) & (si <= ti + self.right_ctx)
        logits = jnp.where(band[None, None], logits, -1e30)
        att = jax.nn.softmax(logits, axis=-1)
        out = jnp.einsum("bhts,bshd->bthd", att, v).reshape(B, T, H * dh)
        out = nn.Dense(self.dim, name="out")(out)
        out = nn.BatchNorm(use_running_average=not train, use_bias=False,
                           use_scale=False, name="batchnorm")(out)
        if D == self.dim:
            out = out + self.bypass_scale * x
        return out

LAYER_TYPES = (
    "input", "relu-batchnorm-layer", "relu-renorm-layer", "tdnnf-layer",
    "fast-lstmp-layer", "attention-relu-batchnorm-layer", "stats-layer",
    "conv-relu-batchnorm-layer", "output-layer", "no-op-component",
)


def _parse_offsets(s: str) -> Tuple[int, ...]:
    return tuple(int(t) for t in s.split(","))


@dataclasses.dataclass(frozen=True)
class XLine:
    """One parsed xconfig line.  All fields hashable (the line tuple is
    a static flax-module field)."""
    layer_type: str
    name: str
    # descriptor: tuple of (referenced layer name | "" = default, offset)
    inputs: Tuple[Tuple[str, int], ...]
    opts: Tuple[Tuple[str, str], ...]

    def opt(self, key: str, default=None) -> Optional[str]:
        for k, v in self.opts:
            if k == key:
                return v
        return default

    def opt_int(self, key: str, default: int = 0) -> int:
        v = self.opt(key)
        return int(v) if v is not None else default

    def opt_float(self, key: str, default: float = 0.0) -> float:
        v = self.opt(key)
        return float(v) if v is not None else default


def _parse_descriptor(desc: str) -> Tuple[Tuple[str, int], ...]:
    """'Append(-1,0,1)' / 'Offset(tdnn1,-3)' / 'tdnn1' / '-1' →
    ((ref, offset), ...); ref '' means the previous layer."""
    desc = desc.strip()
    m = re.fullmatch(r"Append\((.*)\)", desc)
    if m:
        # split top-level commas (Offset(x,-1) has its own comma)
        parts, depth, cur = [], 0, ""
        for ch in m.group(1):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            parts.append(cur)
        out: List[Tuple[str, int]] = []
        for p in parts:
            out.extend(_parse_descriptor(p))
        return tuple(out)
    m = re.fullmatch(r"Offset\(([^,]+),\s*(-?\d+)\)", desc)
    if m:
        return ((m.group(1).strip(), int(m.group(2))),)
    if re.fullmatch(r"-?\d+", desc):
        return (("", int(desc)),)
    if not re.fullmatch(r"[A-Za-z_][\w.\-]*", desc):
        raise KaldiError(f"xconfig: cannot parse descriptor '{desc}'")
    return ((desc, 0),)


def parse_xconfig(text: str) -> Tuple[XLine, ...]:
    """Parse xconfig text into a validated line tuple."""
    lines: List[XLine] = []
    names = set()
    for raw in text.splitlines():
        raw = raw.split("#", 1)[0].strip()
        if not raw:
            continue
        toks = raw.split()
        ltype = toks[0]
        if ltype not in LAYER_TYPES:
            raise KaldiError(f"xconfig: unknown layer type '{ltype}'")
        opts: List[Tuple[str, str]] = []
        name = None
        inputs: Tuple[Tuple[str, int], ...] = (("", 0),)
        for tok in toks[1:]:
            if "=" not in tok:
                raise KaldiError(f"xconfig: bad token '{tok}' in: {raw}")
            k, v = tok.split("=", 1)
            if k == "name":
                name = v
            elif k == "input":
                inputs = _parse_descriptor(v)
            else:
                opts.append((k, v))
        if name is None:
            raise KaldiError(f"xconfig: line missing name=: {raw}")
        if name in names:
            raise KaldiError(f"xconfig: duplicate layer name '{name}'")
        for ref, _ in inputs:
            if ref and ref not in names:
                raise KaldiError(
                    f"xconfig: '{name}' references undefined '{ref}'")
        names.add(name)
        lines.append(XLine(ltype, name, inputs, tuple(opts)))
    if not lines or lines[0].layer_type != "input":
        raise KaldiError("xconfig: first line must be `input name=.. "
                         "dim=..`")
    if not any(l.layer_type == "output-layer" for l in lines):
        raise KaldiError("xconfig: no output-layer")
    return tuple(lines)


def _parse_stats_config(cfg: str) -> Tuple[int, int, bool]:
    """'mean+stddev(-99:3:9:99)' → (left, right, include_stddev)."""
    m = re.fullmatch(r"(mean|mean\+stddev)\((-?\d+):\d+:\d+:(-?\d+)\)",
                     cfg)
    if not m:
        raise KaldiError(f"xconfig: bad stats-layer config '{cfg}'")
    return int(m.group(2)), int(m.group(3)), m.group(1) == "mean+stddev"


class XconfigModel(nn.Module):
    """Interpret a parsed xconfig line tuple as a flax network.

    __call__ (B, T, feat_dim) → dict of output-layer name → tensor.
    `frame_subsampling_factor` subsamples time before the output
    layers (the chain ×3 convention — the reference applies it in the
    computation request, not the xconfig)."""
    lines: Tuple[XLine, ...]
    frame_subsampling_factor: int = 1

    @nn.compact
    def __call__(self, x, train: bool = False):
        tensors: Dict[str, jnp.ndarray] = {}
        prev_name = None
        outputs: Dict[str, jnp.ndarray] = {}

        def resolve(inputs: Tuple[Tuple[str, int], ...]) -> jnp.ndarray:
            cols = []
            for ref, off in inputs:
                src = tensors[ref or prev_name]
                cols.append(splice(src, (off,)) if off else src)
            return cols[0] if len(cols) == 1 else jnp.concatenate(
                cols, axis=-1)

        for line in self.lines:
            lt = line.layer_type
            if lt == "input":
                dim = line.opt_int("dim")
                if x.shape[-1] != dim:
                    raise KaldiError(
                        f"xconfig input dim={dim} but features have "
                        f"dim {x.shape[-1]}")
                tensors[line.name] = x
                prev_name = line.name
                continue
            h = resolve(line.inputs)
            if lt in ("relu-batchnorm-layer", "relu-renorm-layer"):
                h = nn.Dense(line.opt_int("dim"),
                             name=f"{line.name}.affine")(h)
                h = nn.relu(h)
                h = nn.BatchNorm(use_running_average=not train,
                                 use_bias=False, use_scale=False,
                                 name=f"{line.name}.batchnorm")(h)
            elif lt == "tdnnf-layer":
                h = TdnnFLayer(
                    line.opt_int("dim"),
                    line.opt_int("bottleneck-dim",
                                 max(line.opt_int("dim") // 4, 1)),
                    time_stride=line.opt_int("time-stride", 1),
                    bypass_scale=line.opt_float("bypass-scale", 0.66),
                    dropout=line.opt_float("dropout-proportion", 0.0),
                    name=line.name)(h, train=train)
            elif lt == "fast-lstmp-layer":
                h, _ = LstmpLayer(
                    line.opt_int("cell-dim"),
                    line.opt_int("recurrent-projection-dim",
                                 max(line.opt_int("cell-dim") // 2, 1)),
                    name=line.name)(h)
            elif lt == "attention-relu-batchnorm-layer":
                h = RestrictedAttentionLayer(
                    line.opt_int("dim"),
                    num_heads=line.opt_int("num-heads", 4),
                    left_ctx=line.opt_int("num-left-inputs", 9),
                    right_ctx=line.opt_int("num-right-inputs", 9),
                    name=line.name)(h, train=train)
            elif lt == "stats-layer":
                left, right, stddev = _parse_stats_config(
                    line.opt("config", "mean+stddev(-99:3:9:99)"))
                # windowed statistics: mean (and stddev) over
                # [t+left, t+right], causal-clamped — StatsComponent
                # over a moving window; implemented as a cumsum window
                T = h.shape[1]
                csum = jnp.cumsum(h, axis=1)
                csq = jnp.cumsum(h * h, axis=1)
                idx = jnp.arange(T)
                lo = jnp.clip(idx + left, 0, T - 1)
                hi = jnp.clip(idx + right, 0, T - 1)
                n = (hi - lo + 1).astype(h.dtype)[None, :, None]
                take = lambda c: (c[:, hi, :]
                                  - jnp.where((lo > 0)[None, :, None],
                                              c[:, jnp.maximum(lo - 1, 0),
                                                :], 0.0))
                mean = take(csum) / n
                if stddev:
                    var = jnp.maximum(take(csq) / n - mean ** 2, 1e-6)
                    h = jnp.concatenate([mean, jnp.sqrt(var)], axis=-1)
                else:
                    h = mean
            elif lt == "conv-relu-batchnorm-layer":
                from kaldi_tpu.am.cnn import ConvReluBatchnormLayer
                h = ConvReluBatchnormLayer(
                    height_in=line.opt_int("height-in"),
                    num_filters_out=line.opt_int("num-filters-out"),
                    time_offsets=_parse_offsets(
                        line.opt("time-offsets", "-1,0,1")),
                    height_offsets=_parse_offsets(
                        line.opt("height-offsets", "-1,0,1")),
                    height_subsample=line.opt_int(
                        "height-subsample-out", 1),
                    name=line.name)(h, train=train)
            elif lt == "output-layer":
                k = self.frame_subsampling_factor
                if k > 1:
                    h = h[:, ::k, :]
                h = nn.Dense(line.opt_int("dim"),
                             kernel_init=nn.initializers.zeros,
                             name=f"{line.name}.affine")(h)
                if line.opt("include-log-softmax", "true") == "true":
                    h = nn.log_softmax(h, axis=-1)
                outputs[line.name] = h
                # output layers don't feed forward; keep prev pointing
                # at the last hidden layer
                tensors[line.name] = h
                continue
            elif lt == "no-op-component":
                pass
            tensors[line.name] = h
            prev_name = line.name
        return outputs


class XconfigChainModel(nn.Module):
    """XconfigModel adapter with the ChainTrainer model contract:
    apply(variables, x) → one (B, T', num_pdfs) score tensor (the
    named output head).  Keeps `feat_dim` duck-compatible with
    TdnnConfig so ChainTrainer can init from either."""
    lines: Tuple[XLine, ...]
    frame_subsampling_factor: int = 1
    output_name: str = "output"

    @property
    def feat_dim(self) -> int:
        return self.lines[0].opt_int("dim")

    @nn.compact
    def __call__(self, x, train: bool = False):
        outs = XconfigModel(
            lines=self.lines,
            frame_subsampling_factor=self.frame_subsampling_factor,
            name="net")(x, train=train)
        return outs[self.output_name]


def chain_model_from_xconfig(text: str,
                             frame_subsampling_factor: int = 3,
                             output_name: str = "output"
                             ) -> XconfigChainModel:
    """Parse xconfig text into a chain-trainable model (the
    steps/nnet3/chain recipes' xconfig → training-graph step)."""
    lines = parse_xconfig(text)
    out = [l for l in lines if l.name == output_name
           and l.layer_type == "output-layer"]
    if not out:
        raise KaldiError(f"xconfig: no output-layer named "
                         f"'{output_name}'")
    if out[0].opt("include-log-softmax", "true") == "true":
        raise KaldiError(
            "xconfig chain output must set include-log-softmax=false "
            "(chain scores are unnormalized; the denominator "
            "normalizes)")
    return XconfigChainModel(
        lines=lines, frame_subsampling_factor=frame_subsampling_factor,
        output_name=output_name)


def model_from_xconfig(text: str, frame_subsampling_factor: int = 1
                       ) -> Tuple[XconfigModel, int, Dict[str, int]]:
    """Parse + build.  Returns (model, input_dim, {output: dim})."""
    lines = parse_xconfig(text)
    in_dim = lines[0].opt_int("dim")
    out_dims = {l.name: l.opt_int("dim") for l in lines
                if l.layer_type == "output-layer"}
    model = XconfigModel(
        lines=lines, frame_subsampling_factor=frame_subsampling_factor)
    log.info("xconfig: %d layers, input dim %d, outputs %s",
             len(lines), in_dim, out_dims)
    return model, in_dim, out_dims
