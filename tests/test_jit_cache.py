"""core/jit_cache: the persistent compile cache lives where
JAX_COMPILATION_CACHE_DIR says, else in <repo>/.jax_ccache.  Each case
runs in a fresh interpreter (fresh module and JAX config state) and
checks where compiled executables actually land."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import os, sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from kaldi_tpu.core import jit_cache
d = jit_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * {salt})(jnp.ones(7)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("from_env", [True, False])
def test_enable_uses_env_dir_else_repo_dir(tmp_path, from_env):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(REPO, ".jax_ccache")
    if from_env:
        want = str(tmp_path / "cc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    salt = 3.25 if from_env else 4.75
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO, salt=salt)],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.split()
    assert lines[-2] == want and lines[-1] == want
    assert os.path.isdir(want) and os.listdir(want), "no cache entry"
    if from_env:
        # no cache directory appeared in the working directory
        assert not os.path.exists(tmp_path / ".jax_ccache")
