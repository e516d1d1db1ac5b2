"""Numerical building blocks shared by the trainers.

`natural_gradient` is the NG-SGD preconditioner of the reference's
nnet3 trainer (src/nnet3/natural-gradient-online.h), as an optax
transformation.  The feature frontend (features/compute.py) and the
GMM likelihoods (am/gmm.py) are plain jax.numpy left to XLA; a
hand-written kernel joins this package only where a GPU trace shows
its stage hot and far from its roofline.
"""

from kaldi_tpu.ops.natural_gradient import ngsgd

__all__ = ["ngsgd"]
