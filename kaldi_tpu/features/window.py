"""Frame extraction: dither, DC removal, pre-emphasis, windowing.

Parity target: src/feat/feature-window.h — FrameExtractionOptions,
ExtractWindow, ProcessWindow, and the 'povey' window.  Semantics kept
exactly (snip-edges frame count, reflected padding when
snip_edges=False, raw log-energy computed before pre-emphasis) so that
features numerically match the reference pipeline.

Design: framing is a strided gather done once per utterance
batch; everything downstream (pre-emphasis, window multiply, FFT, mel,
DCT) operates on a dense (num_frames, padded_window_size) matrix so XLA
fuses the elementwise stages into the FFT/matmul pipeline.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError


@dataclasses.dataclass
class FrameExtractionOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"   # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def padded_window_size(self) -> int:
        if self.round_to_power_of_two:
            return 1 << (self.window_size - 1).bit_length()
        return self.window_size


def feature_window_function(opts: FrameExtractionOptions) -> np.ndarray:
    """The window vector (feature-window.cc FeatureWindowFunction)."""
    n = opts.window_size
    a = 2 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    if opts.window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif opts.window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif opts.window_type == "povey":
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif opts.window_type == "rectangular":
        w = np.ones(n)
    elif opts.window_type == "blackman":
        b = opts.blackman_coeff
        w = b - 0.5 * np.cos(a * i) + (0.5 - b) * np.cos(2 * a * i)
    else:
        raise KaldiError(f"Invalid window type {opts.window_type}")
    return w.astype(np.float32)


def num_frames(num_samples: int, opts: FrameExtractionOptions) -> int:
    """Frame count (feature-window.cc NumFrames)."""
    shift, length = opts.window_shift, opts.window_size
    if opts.snip_edges:
        if num_samples < length:
            return 0
        return 1 + (num_samples - length) // shift
    return (num_samples + shift // 2) // shift


def first_sample_of_frame(frame: int, opts: FrameExtractionOptions) -> int:
    if opts.snip_edges:
        return frame * opts.window_shift
    midpoint = frame * opts.window_shift + opts.window_shift // 2
    return midpoint - opts.window_size // 2


def extract_frames(waveform: np.ndarray, opts: FrameExtractionOptions,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Slice a waveform into (num_frames, window_size) float32, with dither.

    Dithering happens here (host side, before the device pipeline) with a
    seeded generator — the device compute stays deterministic, matching
    JAX's functional-RNG philosophy rather than the reference's global
    RandGauss stream.
    """
    waveform = np.asarray(waveform, dtype=np.float32)
    n = num_frames(len(waveform), opts)
    size = opts.window_size
    if n == 0:
        return np.zeros((0, size), dtype=np.float32)
    if opts.snip_edges:
        # One strided view covers all frames.
        idx = (np.arange(n)[:, None] * opts.window_shift + np.arange(size)[None, :])
        frames = waveform[idx]
    else:
        starts = np.array([first_sample_of_frame(f, opts) for f in range(n)])
        idx = starts[:, None] + np.arange(size)[None, :]
        # Reflect out-of-range samples (feature-window.cc ExtractWindow).
        idx = np.where(idx < 0, -idx - 1, idx)
        idx = np.where(idx >= len(waveform), 2 * len(waveform) - 1 - idx, idx)
        frames = waveform[np.clip(idx, 0, len(waveform) - 1)]
    frames = frames.astype(np.float32)
    if opts.dither != 0.0:
        if rng is None:
            rng = np.random.default_rng(0)
        frames = frames + opts.dither * rng.standard_normal(
            frames.shape).astype(np.float32)
    return frames


def process_window(frames: jnp.ndarray, window: jnp.ndarray,
                   opts: FrameExtractionOptions,
                   energy_floor_log: float = -1e30):
    """Jittable per-frame processing (feature-window.cc ProcessWindow).

    frames: (F, window_size).  Returns (processed (F, padded), raw log-energy
    (F,)).  Raw energy is taken before pre-emphasis/windowing, as the
    reference does when --raw-energy=true (the default).
    """
    eps = jnp.finfo(jnp.float32).tiny
    if opts.remove_dc_offset:
        frames = frames - jnp.mean(frames, axis=1, keepdims=True)
    log_energy = jnp.log(jnp.maximum(jnp.sum(frames * frames, axis=1), eps))
    if opts.preemph_coeff != 0.0:
        shifted = jnp.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - opts.preemph_coeff * shifted
    frames = frames * window[None, :]
    pad = opts.padded_window_size - frames.shape[1]
    if pad > 0:
        frames = jnp.pad(frames, ((0, 0), (0, pad)))
    return frames, log_energy
