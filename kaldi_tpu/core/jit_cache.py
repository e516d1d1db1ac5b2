"""Persistent XLA compilation cache (the "pay the compile once, ever"
policy).

The reference pays zero JIT cost, so time-to-first-audio parity
demands that a given (program, shape, config) is compiled by XLA at
most once per machine.  ``enable()`` points JAX's persistent
compilation cache at a durable directory; every entry point that
compiles the decoder or a training step calls it.  What stays uncached
is Python tracing and StableHLO lowering, which JAX does not cache.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set,
otherwise the fixed ``<repo>/.jax_ccache``.  The path is part of what
makes a later run hit, so it is never derived from a temporary name,
a pid or the time.

Shape-bucket policy (documented here because it is what makes the
cache finite): utterance batches pad T up to a multiple of the
``bucket`` parameter (pipelines/hard.py `_batches`, bench.py), so an
arbitrary corpus maps onto a handful of executables instead of one
per distinct length.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_ccache")

_enabled_dir = None


def enable() -> str:
    """Idempotently enable the persistent compilation cache and return
    its directory: the environment's, else the repo's."""
    global _enabled_dir
    import jax
    if _enabled_dir is None:
        d = os.environ.get(ENV_VAR) or REPO_DIR
        jax.config.update("jax_compilation_cache_dir", d)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
        _enabled_dir = d
    return _enabled_dir
