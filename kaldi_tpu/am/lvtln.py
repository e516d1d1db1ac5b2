"""Linear VTLN (LVTLN): VTLN approximated by a small bank of linear
feature transforms.

Parity target: src/transform/lvtln.h (LinearVtln) and its binaries
gmmbin/gmm-init-lvtln.cc, gmmbin/gmm-train-lvtln-special.cc,
gmmbin/gmm-est-lvtln-trans.cc.  The reference trains one square D x D
matrix per warp factor by least squares so that ``A_i @ x`` mimics
features recomputed with mel-warp ``w_i``; at test time the class whose
transform maximizes the per-speaker GMM auxiliary objective (including
the +count*log|det A| Jacobian term) is selected, turning VTLN into a
pick-one-of-N linear transform that needs no feature recomputation.

Shape: selection scores every class in one batched pass — transform
all frames by all N matrices with a single (N,D,D)x(T,D) einsum, score
with the model's batched loglike matmuls, and reduce with the posterior
weights.  N is tiny (~20) so the whole search is a handful of matmuls.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)


class Lvtln:
    """A bank of per-warp square linear transforms (LinearVtln role)."""

    def __init__(self, dim: int, num_classes: int,
                 default_class: int = 0):
        if not (0 <= default_class < num_classes):
            raise KaldiError("default_class out of range")
        self.mats = np.tile(np.eye(dim), (num_classes, 1, 1))
        self.warps = np.ones(num_classes)
        self.default_class = default_class

    @property
    def dim(self) -> int:
        return self.mats.shape[1]

    @property
    def num_classes(self) -> int:
        return self.mats.shape[0]

    # ------------------------------------------------------------------
    def set_transform(self, i: int, mat: np.ndarray, warp: float) -> None:
        if mat.shape != (self.dim, self.dim):
            raise KaldiError(f"LVTLN transform shape {mat.shape} != "
                             f"({self.dim}, {self.dim})")
        self.mats[i] = mat
        self.warps[i] = warp

    def train_class(self, i: int, warp: float,
                    pairs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> float:
        """Least-squares fit of class ``i``: A minimizing
        sum_t ||A x_t - y_t||^2 over (x, y) = (unwarped, warped-w) frame
        pairs (gmm-train-lvtln-special).  Returns the per-frame residual
        after fitting (diagnostic the reference logs too)."""
        xs = np.concatenate([np.asarray(x, np.float64) for x, _ in pairs])
        ys = np.concatenate([np.asarray(y, np.float64) for _, y in pairs])
        if xs.shape != ys.shape:
            raise KaldiError("unwarped/warped feature shapes differ")
        # Normal equations shared across output rows: A = (Y^T X)(X^T X)^-1.
        xtx = xs.T @ xs + 1e-6 * np.eye(self.dim)
        ytx = ys.T @ xs
        a = np.linalg.solve(xtx.T, ytx.T).T
        self.set_transform(i, a, warp)
        resid = float(np.mean(np.sum((xs @ a.T - ys) ** 2, axis=1)))
        log.info("LVTLN class %d (warp %.2f): fit on %d frames, "
                 "mean residual %.4f", i, warp, len(xs), resid)
        return resid

    # ------------------------------------------------------------------
    def select(self, am, feats: np.ndarray,
               posts: Optional[List[List[Tuple[int, float]]]] = None,
               ) -> Tuple[int, np.ndarray, float]:
        """Pick the class maximizing the GMM auxiliary objective
        sum_t sum_(p,g) g * loglike_pdf(A_i x_t, p) + count * log|det A_i|
        (gmm-est-lvtln-trans).  ``am`` is an AmDiagGmm; ``posts`` is a
        Posterior (pdf-level); None means a global GMM (pdf 0, weight 1).

        Returns (class index, affine D x (D+1) transform with zero
        offset — ready for transform-feats —, objf improvement per
        frame vs the default class)."""
        feats = np.asarray(feats, np.float64)
        T, D = feats.shape
        if D != self.dim:
            raise KaldiError("feature dim != LVTLN dim")
        if posts is None:
            posts = [[(0, 1.0)] for _ in range(T)]
        count = sum(w for frame in posts for _, w in frame)
        objf = np.zeros(self.num_classes)
        for i in range(self.num_classes):
            warped = feats @ self.mats[i].T
            ll = np.asarray(am.loglikes(warped))          # (T, P)
            acc = 0.0
            for t, frame in enumerate(posts):
                for p, w in frame:
                    acc += w * ll[t, p]
            sign, logdet = np.linalg.slogdet(self.mats[i])
            if sign <= 0:
                raise KaldiError(f"LVTLN class {i} has non-positive "
                                 "determinant")
            objf[i] = acc + count * logdet
        best = int(np.argmax(objf))
        impr = float((objf[best] - objf[self.default_class])
                     / max(count, 1.0))
        affine = np.concatenate(
            [self.mats[best], np.zeros((self.dim, 1))], axis=1)
        return best, affine, impr


# ----------------------------------------------------------------------
# Serialization (Kaldi-style token framing; core/io primitives).

def write_lvtln(f, lv: Lvtln) -> None:
    from kaldi_tpu.core import io as kio
    kio.write_token(f, "<LinearVtln>")
    kio.write_basic_int32(f, lv.dim)
    kio.write_basic_int32(f, lv.num_classes)
    kio.write_basic_int32(f, lv.default_class)
    kio.write_vector(f, lv.warps.astype(np.float32))
    for i in range(lv.num_classes):
        kio.write_matrix(f, lv.mats[i].astype(np.float32))
    kio.write_token(f, "</LinearVtln>")


def read_lvtln(f) -> Lvtln:
    from kaldi_tpu.core import io as kio
    kio.expect_token(f, "<LinearVtln>")
    dim = kio.read_basic_int32(f)
    num_classes = kio.read_basic_int32(f)
    default_class = kio.read_basic_int32(f)
    lv = Lvtln(dim, num_classes, default_class)
    lv.warps = np.asarray(kio.read_vector(f), np.float64)
    for i in range(num_classes):
        lv.mats[i] = np.asarray(kio.read_matrix(f), np.float64)
    kio.expect_token(f, "</LinearVtln>")
    return lv
