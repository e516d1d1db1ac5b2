"""Batched spectral feature computers: MFCC, fbank, spectrogram, PLP.

Parity targets: src/feat/feature-mfcc.h (MfccComputer),
feature-fbank.h (FbankComputer), feature-spectrogram.h, feature-plp.h
(PlpComputer), src/feat/feature-common.h (OfflineFeatureTpl::Compute).

Design: one utterance's frames form a dense
(num_frames, padded_window_size) matrix; the whole pipeline
(pre-emphasis → window → rFFT → |.|² → mel matmul → log → DCT matmul)
is a single jitted function, fused by XLA, with the mel projection and
DCT running on the matrix units.  The reference loops frames one at a time
through a split-radix FFT (srfft.h); here all frames batch through
one XLA FFT.  Computers are stateless; precomputed constant matrices
(window, mel bank, DCT, lifter) are closed over as device constants.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.features.mel import MelBanks, MelBanksOptions
from kaldi_tpu.features.window import (
    FrameExtractionOptions,
    extract_frames,
    feature_window_function,
    process_window,
)

_EPS = float(np.finfo(np.float32).tiny)


def compute_dct_matrix(num_rows: int, num_cols: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (matrix-functions.cc ComputeDctMatrix)."""
    n = np.arange(num_cols)
    mat = np.zeros((num_rows, num_cols))
    mat[0, :] = math.sqrt(1.0 / num_cols)
    for k in range(1, num_rows):
        mat[k, :] = math.sqrt(2.0 / num_cols) * np.cos(
            math.pi / num_cols * (n + 0.5) * k)
    return mat.astype(np.float32)


def compute_lifter_coeffs(q: float, dim: int) -> np.ndarray:
    """Cepstral liftering coefficients (feature-functions.cc)."""
    i = np.arange(dim)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


# ---------------------------------------------------------------------------
# MFCC
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MfccOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0


@dataclasses.dataclass
class FbankOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    use_energy: bool = False
    energy_floor: float = 0.0
    raw_energy: bool = True
    use_log_fbank: bool = True
    use_power: bool = True


@dataclasses.dataclass
class SpectrogramOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    energy_floor: float = 0.0
    raw_energy: bool = True


@dataclasses.dataclass
class PlpOptions:
    frame_opts: FrameExtractionOptions = dataclasses.field(
        default_factory=FrameExtractionOptions)
    mel_opts: MelBanksOptions = dataclasses.field(
        default_factory=lambda: MelBanksOptions(num_bins=23))
    lpc_order: int = 12
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 1.0 / 3.0
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0


class _SpectralBase:
    """Shared framing + power-spectrum stage."""

    def __init__(self, frame_opts: FrameExtractionOptions):
        self.frame_opts = frame_opts
        self._window = np.asarray(feature_window_function(frame_opts), np.float32)

    def _power_spectrum(self, frames: jnp.ndarray):
        processed, log_energy = process_window(frames, self._window,
                                               self.frame_opts)
        spec = jnp.fft.rfft(processed, axis=1)
        power = jnp.real(spec) ** 2 + jnp.imag(spec) ** 2
        return power, log_energy  # (F, nfft//2+1), (F,)

    def frames(self, waveform: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
        return extract_frames(waveform, self.frame_opts, rng)

    def compute(self, waveform: np.ndarray,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Full offline computation for one waveform → (frames, dim).

        The frame count is padded to a 64-frame bucket before the jitted
        spectral pipeline so arbitrary utterance lengths reuse a handful
        of compilations; the pad is sliced off after."""
        frames = self.frames(waveform, rng)
        T = frames.shape[0]
        if T == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        T_pad = ((T + 63) // 64) * 64
        if T_pad != T:
            frames = np.concatenate(
                [frames, np.ones((T_pad - T, frames.shape[1]),
                                 frames.dtype)])
        return np.asarray(self.compute_frames(frames))[:T]


def _floor_energy(log_energy: jnp.ndarray, energy_floor: float) -> jnp.ndarray:
    if energy_floor > 0.0:
        return jnp.maximum(log_energy, math.log(energy_floor))
    return log_energy


class Mfcc(_SpectralBase):
    def __init__(self, opts: MfccOptions = None):
        opts = opts or MfccOptions()
        super().__init__(opts.frame_opts)
        self.opts = opts
        mel = MelBanks(opts.mel_opts, opts.frame_opts)
        self._mel = np.asarray(mel.matrix.T, np.float32)       # (nfft/2+1, num_bins)
        self._dct = np.asarray(
            compute_dct_matrix(opts.num_ceps, opts.mel_opts.num_bins).T)
        if opts.cepstral_lifter != 0.0:
            self._lifter = np.asarray(
                compute_lifter_coeffs(opts.cepstral_lifter, opts.num_ceps))
        else:
            self._lifter = None
        self.dim = opts.num_ceps
        self.compute_frames = jax.jit(self._compute_frames)

    def _compute_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        power, log_energy = self._power_spectrum(frames)
        mel_e = jnp.maximum(power @ self._mel, _EPS)
        ceps = jnp.log(mel_e) @ self._dct
        if self._lifter is not None:
            ceps = ceps * self._lifter[None, :]
        if self.opts.use_energy:
            e = _floor_energy(log_energy, self.opts.energy_floor)
            ceps = ceps.at[:, 0].set(e)
        return ceps


class Fbank(_SpectralBase):
    def __init__(self, opts: FbankOptions = None):
        opts = opts or FbankOptions()
        super().__init__(opts.frame_opts)
        self.opts = opts
        mel = MelBanks(opts.mel_opts, opts.frame_opts)
        self._mel = np.asarray(mel.matrix.T, np.float32)
        self.dim = opts.mel_opts.num_bins + (1 if opts.use_energy else 0)
        self.compute_frames = jax.jit(self._compute_frames)

    def _compute_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        power, log_energy = self._power_spectrum(frames)
        if not self.opts.use_power:
            power = jnp.sqrt(power)
        mel_e = jnp.maximum(power @ self._mel, _EPS)
        out = jnp.log(mel_e) if self.opts.use_log_fbank else mel_e
        if self.opts.use_energy:
            e = _floor_energy(log_energy, self.opts.energy_floor)
            out = jnp.concatenate([e[:, None], out], axis=1)
        return out


class Spectrogram(_SpectralBase):
    def __init__(self, opts: SpectrogramOptions = None):
        opts = opts or SpectrogramOptions()
        super().__init__(opts.frame_opts)
        self.opts = opts
        self.dim = opts.frame_opts.padded_window_size // 2 + 1
        self.compute_frames = jax.jit(self._compute_frames)

    def _compute_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        power, log_energy = self._power_spectrum(frames)
        out = jnp.log(jnp.maximum(power, _EPS))
        e = _floor_energy(log_energy, self.opts.energy_floor)
        return out.at[:, 0].set(e)


# ---------------------------------------------------------------------------
# PLP
# ---------------------------------------------------------------------------

def _equal_loudness(center_freqs: np.ndarray) -> np.ndarray:
    """Equal-loudness curve (mel-computations.cc GetEqualLoudnessVector)."""
    fsq = center_freqs.astype(np.float64) ** 2
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)


def _idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """feature-functions.cc InitIdftBases."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases)[:, None].astype(np.float64)
    j = np.arange(dimension)[None, :].astype(np.float64)
    mat = 2.0 * scale * np.cos(angle * i * j)
    mat[:, 0] = scale
    mat[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return mat.astype(np.float32)


def _durbin(autocorr: jnp.ndarray, order: int):
    """Levinson-Durbin, vectorized over frames.

    autocorr: (F, order+1).  Returns (lpc (F, order), residual energy (F,)).
    Mirrors matrix-functions.cc Durbin but as a lax.fori_loop over the
    (small, static) LPC order with all frames in parallel.
    """
    F = autocorr.shape[0]
    lpc = jnp.zeros((F, order))
    err = autocorr[:, 0]

    def body(i, carry):
        lpc, err = carry
        # ki = (r[i+1] - sum_{j<i} lpc[j] * r[i-j]) / err
        idx = i - jnp.arange(order)          # r index per j; valid where j < i
        valid = jnp.arange(order) < i
        r_gather = jnp.take_along_axis(
            autocorr, jnp.broadcast_to(jnp.clip(idx, 0, order)[None, :], (F, order)),
            axis=1)
        acc = jnp.sum(jnp.where(valid[None, :], lpc * r_gather, 0.0), axis=1)
        ki = (autocorr[:, i + 1] - acc) / jnp.maximum(err, _EPS)
        # a'_j = a_j - ki * a_{i-1-j}
        rev_idx = i - 1 - jnp.arange(order)
        rev_valid = jnp.arange(order) < i
        a_rev = jnp.take_along_axis(
            lpc, jnp.broadcast_to(jnp.clip(rev_idx, 0, order - 1)[None, :],
                                  (F, order)), axis=1)
        new_lpc = jnp.where(rev_valid[None, :], lpc - ki[:, None] * a_rev, lpc)
        new_lpc = new_lpc.at[:, i].set(ki)
        err = err * (1.0 - ki * ki)
        return new_lpc, err

    lpc, err = jax.lax.fori_loop(0, order, body, (lpc, err))
    return lpc, err


def _lpc_to_cepstrum(lpc: jnp.ndarray, order: int, num_ceps: int) -> jnp.ndarray:
    """LPC → cepstrum recursion (matrix-functions.cc Lpc2Cepstrum),
    vectorized over frames."""
    F = lpc.shape[0]
    ceps = jnp.zeros((F, num_ceps))

    def body(i, ceps):
        # i is 1-based cepstral index
        j = jnp.arange(1, num_ceps)
        valid = (j < i) & (i - j - 1 < order)
        lpc_idx = jnp.clip(i - j - 1, 0, order - 1)
        lpc_g = lpc[:, lpc_idx]                     # (F, num_ceps-1)
        ceps_g = ceps[:, jnp.clip(j - 1, 0, num_ceps - 1)]
        acc = jnp.sum(jnp.where(valid[None, :], j[None, :] * ceps_g * lpc_g, 0.0),
                      axis=1)
        direct = jnp.where(i <= order, lpc[:, jnp.clip(i - 1, 0, order - 1)], 0.0)
        val = direct + acc / i
        return ceps.at[:, i - 1].set(val)

    return jax.lax.fori_loop(1, num_ceps + 1, body, ceps)


class Plp(_SpectralBase):
    def __init__(self, opts: PlpOptions = None):
        opts = opts or PlpOptions()
        super().__init__(opts.frame_opts)
        self.opts = opts
        mel = MelBanks(opts.mel_opts, opts.frame_opts)
        self._mel = np.asarray(mel.matrix.T, np.float32)
        self._equal_loudness = np.asarray(_equal_loudness(mel.center_freqs), np.float32)
        self._idft = np.asarray(
            _idft_bases(opts.lpc_order + 1, opts.mel_opts.num_bins + 2).T)
        if opts.cepstral_lifter != 0.0:
            self._lifter = np.asarray(
                compute_lifter_coeffs(opts.cepstral_lifter, opts.num_ceps))
        else:
            self._lifter = None
        self.dim = opts.num_ceps
        self.compute_frames = jax.jit(self._compute_frames)

    def _compute_frames(self, frames: jnp.ndarray) -> jnp.ndarray:
        o = self.opts
        power, log_energy = self._power_spectrum(frames)
        mel_e = jnp.maximum(power @ self._mel, _EPS)          # (F, nbins)
        mel_e = (mel_e * self._equal_loudness[None, :]) ** o.compress_factor
        # Duplicate first and last bins (feature-plp.cc).
        dup = jnp.concatenate([mel_e[:, :1], mel_e, mel_e[:, -1:]], axis=1)
        autocorr = dup @ self._idft                            # (F, order+1)
        lpc, resid = _durbin(autocorr, o.lpc_order)
        # The reference negates LPC coeffs inside Durbin's convention;
        # _durbin returns reflection-form coefficients compatible with
        # _lpc_to_cepstrum below.
        ceps = _lpc_to_cepstrum(lpc, o.lpc_order, o.num_ceps)
        c0 = jnp.log(jnp.maximum(resid, _EPS))
        out = jnp.concatenate([c0[:, None], ceps[:, :o.num_ceps - 1]], axis=1)
        if self._lifter is not None:
            out = out * self._lifter[None, :]
        if o.cepstral_scale != 1.0:
            out = out * o.cepstral_scale
        if o.use_energy:
            e = _floor_energy(log_energy, o.energy_floor)
            out = out.at[:, 0].set(e)
        return out
