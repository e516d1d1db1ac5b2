"""Real multi-process jax.distributed test: two local CPU processes
form one global mesh; psum stat reduction and data-parallel gradients
must match the single-process computation exactly (SURVEY.md §2.4
comm-backend row — previously only single-process virtual meshes were
exercised)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    out_prefix = str(tmp_path / "dist")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    procs = []
    for pid in range(2):
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kaldi_tpu.parallel.distributed",
             coord, "2", str(pid), out_prefix],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            cwd=os.path.dirname(os.path.dirname(__file__))))
    outs = []
    for p in procs:
        try:
            stdout, stderr = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, stdout, stderr))
    for rc, stdout, stderr in outs:
        assert rc == 0, stderr.decode()[-2000:]

    r0 = np.load(f"{out_prefix}.0.npz")
    r1 = np.load(f"{out_prefix}.1.npz")
    assert int(r0["ndev"]) == 4          # 2 processes × 2 devices
    # sharded lattice decode: each process decoded its OWN shard of
    # the global batch on the global mesh and verified every lattice
    # against a single-device decode in-process (the multi-host
    # analogue of the dryrun's multi-device equality)
    for r in (r0, r1):
        assert int(r["decode_ok"]) == 1
        assert int(r["n_lats"]) == 4     # 2 rows × 2 local devices
    # chain train step on the global mesh: SPMD — both processes see
    # the identical loss and updated params
    assert np.isfinite(float(r0["chain_loss"]))
    np.testing.assert_allclose(float(r0["chain_loss"]),
                               float(r1["chain_loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(r0["chain_p0"]),
                               float(r1["chain_p0"]), rtol=1e-6)
    # ... and the loss matches the same step computed single-process
    from kaldi_tpu.am.chain import make_denominator_graph
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    import jax.numpy as jnp
    phones = list(range(1, 9))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    crng = np.random.default_rng(0)
    seqs = [list(crng.integers(1, 9, 8)) for _ in range(30)]
    den = make_denominator_graph(seqs, tree, topo, order=2)
    ccfg = TdnnConfig(feat_dim=8, num_pdfs=tree.num_pdfs, hidden_dim=16,
                      bottleneck_dim=8, num_layers=3,
                      frame_subsampling_factor=3)
    trainer = ChainTrainer(ccfg, den,
                           ChainTrainConfig(batch_size=8, total_steps=0))
    Bc, Tc = 8, 24
    feats = crng.standard_normal((Bc, Tc, 8)).astype(np.float32)
    pdf_ali = crng.integers(0, tree.num_pdfs, (Bc, Tc // 3)).astype(
        np.int32)
    cmask = np.ones((Bc, Tc // 3), bool)
    _p, _bs, _ost, loss, _diag = trainer._step(
        trainer.params, trainer.batch_stats, trainer.opt_state,
        jnp.asarray(feats), jnp.asarray(pdf_ali), jnp.asarray(cmask))
    np.testing.assert_allclose(float(r0["chain_loss"]), float(loss),
                               rtol=1e-4)
    # both processes agree on the reduced stats
    np.testing.assert_allclose(r0["total"], r1["total"], rtol=1e-6)
    # and they equal the single-process sum of the per-process stats
    expect = sum(np.random.default_rng(100 + pid).standard_normal(
        (4, 3)).astype(np.float32) for pid in range(2))
    np.testing.assert_allclose(r0["total"], expect, rtol=1e-5, atol=1e-6)
    # data-parallel gradient equals the full-batch gradient
    D = 8
    grng = np.random.default_rng(7)
    gb = grng.standard_normal((4 * 4, D)).astype(np.float32)
    gy = gb @ (np.arange(D) * 0.1)
    W = np.linspace(-1, 1, D).astype(np.float32)
    ref = 2 * gb.T @ (gb @ W - gy) / len(gy)
    np.testing.assert_allclose(r0["grad"], ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r1["grad"], ref, rtol=1e-4, atol=1e-5)
