"""Mesh and sharding helpers.

Axes:
  data  — utterance/chunk batches (the analogue of --nj job splitting)
  model — tensor parallelism for layers too big for one chip
          (no reference equivalent: CuDevice is single-GPU; this is the
          BASELINE.json north-star requirement)

Rules follow the scaling-book recipe: annotate shardings on params and
batches, let XLA insert the collectives (psum for grad reduction rides
the interconnect automatically under jit).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(data: int = 0, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with (data, model) axes; data=0 → use all remaining devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if model < 1 or n % model:
        raise ValueError(f"model axis {model} does not divide {n} devices")
    if data == 0:
        data = n // model
    if data * model != n:
        devices = devices[: data * model]
    arr = np.array(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading batch axis over 'data', everything else replicated."""
    return NamedSharding(mesh, P("data"))


def model_sharding_rules(path_names: Sequence[str]) -> P:
    """PartitionSpec for a param identified by its tree path.

    Dense kernels (in, out) shard the output features over 'model'
    (column parallelism); biases/batch-norm stats replicate.  The
    alternating row-parallel factor of TDNN-F ('affine' after 'linear')
    shards its INPUT dim so the pair needs only one collective.
    """
    names = list(path_names)
    if names and names[-1] == "kernel":
        if "affine" in names:          # second factor: row-parallel
            return P("model", None)
        return P(None, "model")        # column-parallel
    return P()


def shard_params(params, mesh: Mesh):
    """Apply model_sharding_rules across a param pytree."""
    def spec_for(path):
        names = [getattr(p, "key", getattr(p, "name", "")) for p in path]
        return NamedSharding(mesh, model_sharding_rules(names))

    flat = jax.tree_util.tree_flatten_with_path(params)
    leaves = [(path, jax.device_put(leaf, spec_for(path)))
              for path, leaf in flat[0]]
    return jax.tree_util.tree_unflatten(flat[1], [l for _, l in leaves])


def replicate(tree, mesh: Mesh):
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
