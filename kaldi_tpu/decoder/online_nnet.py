"""Streaming neural acoustic scoring.

Parity target: src/nnet3/decodable-online-looped.h
(DecodableAmNnetLoopedOnline) — chunked TDNN scoring that carries
enough temporal context across chunks for online decoding.

The reference compiles a 'looped' computation carrying recurrent state;
a TDNN's state is just its finite receptive field, so the
equivalent is context-buffered chunk scoring: keep `left_context`
feature frames from the past, delay emission by `right_context` frames,
and score each chunk with both attached.  Scores for emitted frames are
then exactly those context frames would produce offline up to the
model's receptive field (tested against the offline forward).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)


class OnlineNnetScorer:
    """Feed feature chunks, read subsampled score frames."""

    def __init__(self, apply_fn, left_context: int = 24,
                 right_context: int = 24, subsample: int = 3):
        """apply_fn: jitted (1, T, D) → (1, T // subsample, P)."""
        self.apply_fn = apply_fn
        self.left = left_context
        self.right = right_context
        self.sub = subsample
        self._feats: Optional[np.ndarray] = None
        self._emitted_sub = 0          # subsampled frames already emitted
        self._finished = False

    def accept_features(self, feats: np.ndarray) -> None:
        if self._finished:
            raise KaldiError("accept_features after input_finished")
        feats = np.asarray(feats, np.float32)
        self._feats = (feats if self._feats is None
                       else np.concatenate([self._feats, feats]))

    def input_finished(self) -> None:
        self._finished = True

    def num_frames_ready(self) -> int:
        """Subsampled score frames currently computable."""
        if self._feats is None:
            return 0
        T = self._feats.shape[0]
        usable = T if self._finished else max(0, T - self.right)
        return usable // self.sub

    def get_scores(self, begin_sub: int, end_sub: int) -> np.ndarray:
        """Scores for subsampled frames [begin_sub, end_sub)."""
        if end_sub > self.num_frames_ready():
            raise KaldiError("scores not ready")
        # score the window [begin_full - left, end_full + right] and cut
        begin_full = begin_sub * self.sub
        end_full = end_sub * self.sub
        lo = max(0, begin_full - self.left)
        # keep lo aligned to the subsampling grid so frame phases match
        lo -= lo % self.sub
        hi = min(self._feats.shape[0], end_full + self.right)
        window = self._feats[lo:hi]
        scores = np.asarray(self.apply_fn(window[None])[0])
        off = (begin_full - lo) // self.sub
        return scores[off:off + (end_sub - begin_sub)]

    def read_new(self) -> np.ndarray:
        """All not-yet-emitted ready frames (streaming pull)."""
        ready = self.num_frames_ready()
        if ready <= self._emitted_sub:
            return np.zeros((0, 0), np.float32)
        out = self.get_scores(self._emitted_sub, ready)
        self._emitted_sub = ready
        return out
