"""Time-height convolution (the nnet3 CNN component family).

Parity target: src/nnet3/nnet-convolutional-component.h
(TimeHeightConvolutionComponent) — the reference treats each frame's
feature vector as a (height, filters) image column and convolves over
(time-offset, height-offset) taps; CNN-TDNN recipes
(egs/*/local/chain/tuning/run_cnn_tdnn*.sh) stack a few of these as
`conv-relu-batchnorm-layer` xconfig lines in front of the TDNN-F
trunk, optionally downsampling height (height-subsample-out).

Design: the whole layer is one `lax.conv_general_dilated` — XLA
lowers it onto the matrix units directly, replacing the reference's im2row +
GEMM expansion (ConvolutionComputation::ConvolveForward).  Time taps
use SAME-style zero padding (the reference zero-pads required context
at utterance edges); height taps pad explicitly per the requested
offsets so height-out is exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


def _contiguous(offsets: Sequence[int], what: str) -> Tuple[int, int]:
    """Validate an offset list is a contiguous range (the reference
    supports arbitrary offset sets, but every shipped recipe uses
    contiguous taps, which is what a dense conv kernel expresses)."""
    off = sorted(int(o) for o in offsets)
    if not off or off != list(range(off[0], off[-1] + 1)):
        raise ValueError(
            f"{what} offsets must be a contiguous range, got {offsets}")
    return off[0], off[-1]


class TimeHeightConv(nn.Module):
    """(B, T, height_in * filters_in) → (B, T, height_out * filters_out).

    `time_offsets`/`height_offsets` are the conv taps relative to the
    output position (e.g. (-1, 0, 1)); `height_subsample` strides the
    height axis (height_out = ceil(height_padded / subsample))."""
    height_in: int
    num_filters_out: int
    time_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_subsample: int = 1

    @nn.compact
    def __call__(self, x):
        B, T, D = x.shape
        if D % self.height_in:
            raise ValueError(
                f"feature dim {D} not divisible by height_in "
                f"{self.height_in}")
        cin = D // self.height_in
        t0, t1 = _contiguous(self.time_offsets, "time")
        h0, h1 = _contiguous(self.height_offsets, "height")
        img = x.reshape(B, T, self.height_in, cin)
        kernel = self.param(
            "kernel", nn.initializers.lecun_normal(),
            (t1 - t0 + 1, h1 - h0 + 1, cin, self.num_filters_out))
        bias = self.param("bias", nn.initializers.zeros,
                          (self.num_filters_out,))
        # padding chosen so output index t reads input taps t+t0..t+t1
        # (and likewise for height), matching Offset descriptor
        # semantics with zero padding at the edges
        out = jax.lax.conv_general_dilated(
            img, kernel,
            window_strides=(1, self.height_subsample),
            padding=((-t0, t1), (-h0, h1)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        out = out + bias
        hout = out.shape[2]
        return out.reshape(B, T, hout * self.num_filters_out), hout


class ConvReluBatchnormLayer(nn.Module):
    """conv-relu-batchnorm-layer: TimeHeightConv → ReLU → BatchNorm
    (the xconfig CNN building block)."""
    height_in: int
    num_filters_out: int
    time_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_offsets: Tuple[int, ...] = (-1, 0, 1)
    height_subsample: int = 1

    @nn.compact
    def __call__(self, x, train: bool = False):
        h, _ = TimeHeightConv(
            self.height_in, self.num_filters_out, self.time_offsets,
            self.height_offsets, self.height_subsample, name="conv")(x)
        h = nn.relu(h)
        h = nn.BatchNorm(use_running_average=not train, use_bias=False,
                         use_scale=False, name="batchnorm")(h)
        return h
