"""Parallelism: device meshes, shardings, collectives.

Replaces the reference's distribution story (SURVEY.md §2.4): where
Kaldi shards work as filesystem jobs glued by run.pl/queue.pl and
reduces via gmm-sum-accs / nnet3-average, kaldi_tpu uses a
jax.sharding.Mesh with named axes and XLA collectives (psum over the interconnect).
"""

from kaldi_tpu.parallel.mesh import (
    make_mesh,
    batch_sharding,
    model_sharding_rules,
    shard_params,
    replicate,
)

__all__ = ["make_mesh", "batch_sharding", "model_sharding_rules",
           "shard_params", "replicate"]
