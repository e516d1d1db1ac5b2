"""Multi-process distributed runtime.

Parity target: the reference's cross-machine story is a shared
filesystem + queue.pl job dispatch (SURVEY.md §2.4 comm-backend row);
the JAX equivalent is jax.distributed.initialize — one process per
host, devices federated into one global mesh, collectives over the
interconnect instead of ark files on NFS.

`worker_main` is the per-process entry (the run.pl "job"): it joins
the coordinator, builds a global mesh over all processes' devices,
shards a global batch across processes with
make_array_from_process_local_data, and runs cross-process reductions
under jit over the global mesh — the gmm-sum-accs / nnet3-average
role.  The test
suite launches two local CPU processes against it
(tests/test_distributed.py), which is exactly how the reference
exercises "cluster" paths locally (run.pl backgrounds jobs on one
machine).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from kaldi_tpu.core.logging import get_logger

log = get_logger(__name__)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """jax.distributed.initialize wrapper (idempotent per process)."""
    import jax
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("distributed: process %d/%d up, %d local / %d global devices",
             process_id, num_processes, jax.local_device_count(),
             jax.device_count())


def global_mesh(axis_name: str = "data"):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def psum_stats(local_stats: np.ndarray, mesh=None) -> np.ndarray:
    """Sum per-process statistics across the global mesh (the
    gmm-sum-accs reduction as a psum collective).  local_stats: this
    process's contribution; every process must call this."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    mesh = mesh or global_mesh()
    n = jax.process_count()
    # one shard per process: build the global (n, ...) array from each
    # process's local row
    from jax.sharding import NamedSharding
    global_shape = (jax.device_count(),) + local_stats.shape
    local_rows = np.broadcast_to(
        local_stats[None] / jax.local_device_count(),
        (jax.local_device_count(),) + local_stats.shape)
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), np.ascontiguousarray(local_rows),
        global_shape)

    @jax.jit
    def reduce(a):
        return jnp.sum(a, axis=0)

    return np.asarray(jax.device_get(reduce(arr)))


def worker_main(argv=None) -> int:
    """Entry for the distributed smoke worker:

        python -m kaldi_tpu.parallel.distributed <coord> <nproc> <pid> \
            <out_prefix>

    Each process contributes deterministic per-process GMM-style stats
    and a gradient; the psum-reduced results are written to
    <out_prefix>.<pid>.npz for the launching test to compare."""
    argv = argv if argv is not None else sys.argv[1:]
    coord, nproc, pid, out_prefix = (argv[0], int(argv[1]), int(argv[2]),
                                     argv[3])
    import jax
    initialize(coord, nproc, pid)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_mesh()
    # 1. stat reduction (gmm-sum-accs role)
    rng = np.random.default_rng(100 + pid)
    local = rng.standard_normal((4, 3)).astype(np.float32)
    total = psum_stats(local, mesh)

    # 2. data-parallel gradient step (nnet3-average role, done as true
    #    synchronous psum-grad SGD): global batch sharded on 'data'
    D = 8
    W = np.linspace(-1, 1, D).astype(np.float32)
    ndev = jax.device_count()
    ldev = jax.local_device_count()
    per_dev = 4
    gb = np.zeros((ndev * per_dev, D), np.float32)
    gy = np.zeros((ndev * per_dev,), np.float32)
    grng = np.random.default_rng(7)        # same on all processes
    gb[:] = grng.standard_normal(gb.shape)
    gy[:] = gb @ (np.arange(D) * 0.1)
    lo = pid * ldev * per_dev
    hi = lo + ldev * per_dev
    X = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), np.ascontiguousarray(gb[lo:hi]),
        gb.shape)
    Y = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("data")), np.ascontiguousarray(gy[lo:hi]),
        gy.shape)

    @jax.jit
    def grad_step(W, X, Y):
        def loss(W):
            return jnp.mean((X @ W - Y) ** 2)
        return jax.grad(loss)(W)

    g = np.asarray(jax.device_get(grad_step(jnp.asarray(W), X, Y)))

    # 3. two-process SHARDED LATTICE DECODE equality (the multi-host
    #    analogue of the dryrun's multi-device proof):
    #    the batch is sharded over the global mesh, each process feeds
    #    and fetches only its addressable shard, builds its own
    #    lattices, and verifies them against a single-device decode of
    #    the same utterances IN-PROCESS.
    from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu.parallel.decode import ShardedBeamDecoder
    from kaldi_tpu.parallel.mesh import make_mesh
    from kaldi_tpu.pipelines.largevocab import (make_largevocab_task,
                                                sample_eval_set,
                                                synth_loglikes)
    # (data, model=1) mesh: the trainer's param-sharding rules name
    # the 'model' axis even when it is trivial
    mesh2 = make_mesh(model=1)
    task = make_largevocab_task(vocab_size=600, corpus_sentences=600,
                                seed=3)
    dec = BeamDecoder(task.graph.csr, task.tm.tid_to_pdf_array,
                      BeamDecoderConfig(beam=14.0, max_active=512,
                                        acoustic_scale=1.0,
                                        lattice_beam=6.0,
                                        lattice_arcs_per_frame=1024,
                                        record_capacity=16384))
    sharded = ShardedBeamDecoder(dec, mesh2)
    ldev = jax.local_device_count()
    Bl = 2 * ldev                       # rows for THIS process
    eval_set = sample_eval_set(task, Bl * nproc, max_words=4, seed=5)
    urng = np.random.default_rng(17)    # same stream on all processes
    all_lls = [synth_loglikes(task, s, urng, noise=0.3)
               for _, s in sorted(eval_set.items())]
    T_pad = 64
    Xd = np.zeros((Bl * nproc, T_pad, task.num_pdfs), np.float32)
    lensd = np.zeros(Bl * nproc, np.int32)
    for i, ll in enumerate(all_lls):
        Xd[i, :len(ll)] = ll[:T_pad]
        lensd[i] = min(len(ll), T_pad)
    lo = pid * Bl
    lats = sharded.decode_compact_local(Xd[lo:lo + Bl],
                                        lensd[lo:lo + Bl])
    decode_ok = 1
    for b, lat in enumerate(lats):
        ref = dec.decode_compact(Xd[lo + b][:lensd[lo + b]], bucket=64)
        gw, _gt, gc = lat.best_path()
        rw, _rt, rc = ref.best_path()
        if gw != rw or abs(gc - rc) > 1e-3:
            decode_ok = 0
            log.info("worker %d: decode mismatch at row %d", pid, b)

    # 4. two-process CHAIN TRAIN step: psum-grad data-parallel step on
    #    the global mesh must match all processes bit-for-bit (SPMD)
    from kaldi_tpu.am.chain import make_denominator_graph
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    phones = list(range(1, 9))
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    crng = np.random.default_rng(0)
    seqs = [list(crng.integers(1, 9, 8)) for _ in range(30)]
    den = make_denominator_graph(seqs, tree, topo, order=2)
    ccfg = TdnnConfig(feat_dim=8, num_pdfs=tree.num_pdfs, hidden_dim=16,
                      bottleneck_dim=8, num_layers=3,
                      frame_subsampling_factor=3)
    trainer = ChainTrainer(ccfg, den, ChainTrainConfig(
        batch_size=ndev * 2, total_steps=0), mesh=mesh2)
    Bc, Tc = ndev * 2, 24
    feats = crng.standard_normal((Bc, Tc, 8)).astype(np.float32)
    pdf_ali = crng.integers(0, tree.num_pdfs, (Bc, Tc // 3)).astype(
        np.int32)
    cmask = np.ones((Bc, Tc // 3), bool)
    # explicit replicated global arrays for the step inputs (numpy
    # inputs have no committed sharding in multi-process SPMD)
    repl = NamedSharding(mesh2, P())
    fg, ag, mg = (jax.device_put(x, repl)
                  for x in (feats, pdf_ali, cmask))
    with mesh2:
        p, bs, ost, loss, diag = trainer._step(
            trainer.params, trainer.batch_stats, trainer.opt_state,
            fg, ag, mg)
    chain_loss = float(jax.device_get(loss))
    p0 = float(jax.device_get(jnp.sum(
        jax.tree_util.tree_leaves(p)[0])))

    np.savez(f"{out_prefix}.{pid}.npz", total=total, grad=g,
             ndev=np.asarray(jax.device_count()),
             decode_ok=np.asarray(decode_ok),
             n_lats=np.asarray(len(lats)),
             chain_loss=np.asarray(chain_loss),
             chain_p0=np.asarray(p0))
    log.info("worker %d done: devices=%d decode_ok=%d chain_loss=%.5f",
             pid, jax.device_count(), decode_ok, chain_loss)
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
