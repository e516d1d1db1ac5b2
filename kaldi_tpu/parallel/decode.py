"""Sharded batched decoding over a device mesh.

Parity target: the reference's decode-time parallelism — steps/decode.sh
--nj N fanning out processes over data splits (SURVEY.md §2.4 row 3) —
and the BASELINE.json north-star config 5 ('multi-host pod decode:
eval sharded across hosts').

Shape: the utterance batch is sharded over the mesh 'data' axis; the
graph arrays are replicated into every device's memory (they are
read-only decode state, the CudaFst residency model); the whole
batch-decode scan runs under one jit, XLA partitioning the vmapped
scan across devices with no collectives in the steady state (per-utterance
beams are independent, matching Kaldi's per-process semantics).  On a
multi-host pod the same code runs under jax.distributed.initialize
with a global mesh — each host feeds its local shard.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaldi_tpu.core.logging import get_logger
from kaldi_tpu.decoder.dense import DenseDecoder

log = get_logger(__name__)


class ShardedDecoder:
    """Wraps a DenseDecoder for data-parallel batch decode on a mesh."""

    def __init__(self, decoder: DenseDecoder, mesh: Mesh):
        self.dec = decoder
        self.mesh = mesh
        self._jit = None

    def _build(self):
        dec = self.dec
        mesh = self.mesh
        batch_sh = NamedSharding(mesh, P("data"))
        repl = NamedSharding(mesh, P())

        vmapped = jax.vmap(dec._decode_scan, in_axes=(0, 0))
        self._jit = jax.jit(
            vmapped,
            in_shardings=(batch_sh, batch_sh),
            out_shardings=batch_sh)

    def decode_batch(self, loglikes_padded: np.ndarray,
                     num_frames: np.ndarray):
        """(B, T_pad, P) with B divisible by the data-axis size."""
        if self._jit is None:
            self._build()
        ndata = self.mesh.shape["data"]
        B = loglikes_padded.shape[0]
        pad_b = (-B) % ndata
        if pad_b:
            loglikes_padded = np.concatenate(
                [loglikes_padded,
                 np.zeros((pad_b,) + loglikes_padded.shape[1:],
                          loglikes_padded.dtype)])
            num_frames = np.concatenate(
                [num_frames, np.ones(pad_b, num_frames.dtype)])
        with self.mesh:
            out = self._jit(jnp.asarray(loglikes_padded, jnp.float32),
                            jnp.asarray(num_frames, jnp.int32))
        out = jax.tree_util.tree_map(np.asarray, out)
        results = []
        for b in range(B):
            one = jax.tree_util.tree_map(lambda x: x[b], out)
            results.append(self.dec._backtrace(one, int(num_frames[b])))
        return results


class ShardedBeamDecoder:
    """Data-parallel LARGE-GRAPH lattice decode on a mesh: the
    utterance batch is sharded over 'data', the packed CSR arc table
    is replicated into every device's memory (the multi-lane CudaFst
    residency), and each shard runs the sort-recombination scan
    independently — no collectives in the steady state, matching the
    reference's per-process decode semantics at pod scale
    (BASELINE.json north-star config 5)."""

    def __init__(self, decoder, mesh: Mesh):
        from kaldi_tpu.decoder.beam import BeamDecoder
        assert isinstance(decoder, BeamDecoder)
        self.dec = decoder
        self.mesh = mesh
        self._jit = None
        self._g = None

    def graph_arrays(self):
        """The packed graph, replicated onto every device of the mesh
        (uploaded once, on first use)."""
        if self._g is None:
            self._g = jax.device_put(self.dec._g_host,
                                     NamedSharding(self.mesh, P()))
        return self._g

    def _build(self):
        batch_sh = NamedSharding(self.mesh, P("data"))
        repl = NamedSharding(self.mesh, P())
        vmapped = jax.vmap(self.dec._decode_scan, in_axes=(None, 0, 0))
        self._jit = jax.jit(vmapped,
                            in_shardings=(repl, batch_sh, batch_sh),
                            out_shardings=batch_sh)

    def decode_compact_batch(self, loglikes_padded: np.ndarray,
                             num_frames: np.ndarray,
                             stats: Optional[dict] = None):
        """(B, T_pad, P) → determinized CompactLattices (fused native
        build+determinize per utterance on host).  B is padded up to a
        multiple of the data-axis size.  ``stats`` also receives
        ``out_devices``, the number of devices the decode ran on.  The
        BeamDecoder's
        demand-triggered escalation policy (escalate_budget) is
        honored: flagged utterances re-decode single-device at the
        wider budget — retries are rare by design, so they don't
        merit a sharded path of their own."""
        if self._jit is None:
            self._build()
        ndata = self.mesh.shape["data"]
        B = loglikes_padded.shape[0]
        pad_b = (-B) % ndata
        X = loglikes_padded
        lens = num_frames
        if pad_b:
            X = np.concatenate(
                [X, np.zeros((pad_b,) + X.shape[1:], X.dtype)])
            lens = np.concatenate(
                [lens, np.ones(pad_b, num_frames.dtype)])
        with self.mesh:
            out = self._jit(self.graph_arrays(),
                            jnp.asarray(X, jnp.float32),
                            jnp.asarray(lens, jnp.int32))
        if stats is not None:
            stats["out_devices"] = len(out["bt_aidx"].sharding.device_set)
        hosts = self.dec._fetch_batch(out, B, lattice=True)
        lats = []
        for b in range(B):
            T = int(num_frames[b])
            host, dec = self.dec._maybe_escalate(hosts[b], X[b], T)
            if stats is not None:
                stats["min_eff_beam"] = min(
                    stats.get("min_eff_beam", float("inf")),
                    float(host["min_eff_beam"]))
                stats["n_escalated"] = (stats.get("n_escalated", 0)
                                        + int(dec is not self.dec))
            lats.append(dec.build_compact_lattice(host, T, X[b]))
        return lats

    def decode_compact_local(self, X_local: np.ndarray,
                             lens_local: np.ndarray):
        """MULTI-PROCESS entry (jax.distributed global mesh): each
        process passes its LOCAL shard of the utterance batch — rows
        for its own devices only — and gets back lattices for exactly
        those rows.  This is the pod decode architecture (BASELINE
        north-star config 5): the jit is global SPMD over the mesh,
        but every host feeds and fetches only its addressable shards
        and builds its own lattices, the steps/decode.sh --nj split
        over hosts.  X_local.shape[0] must be a multiple of the LOCAL
        device count; all processes must pass the same shapes."""
        import jax as _jax
        if self._jit is None:
            self._build()
        batch_sh = NamedSharding(self.mesh, P("data"))
        Bl = X_local.shape[0]
        nproc = _jax.process_count()
        gshape = (Bl * nproc,) + X_local.shape[1:]
        X = _jax.make_array_from_process_local_data(
            batch_sh, np.ascontiguousarray(X_local, np.float32), gshape)
        lens = _jax.make_array_from_process_local_data(
            batch_sh, np.ascontiguousarray(lens_local, np.int32),
            (Bl * nproc,))
        with self.mesh:
            out = self._jit(self.graph_arrays(), X, lens)

        def local_rows(leaf):
            shards = sorted(leaf.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            return np.concatenate([np.asarray(s.data) for s in shards])

        out_local = {k: local_rows(v) for k, v in out.items()}
        hosts = self.dec._fetch_batch(out_local, Bl, lattice=True)
        lats = []
        for b in range(Bl):
            T = int(lens_local[b])
            host, dec = self.dec._maybe_escalate(hosts[b], X_local[b], T)
            lats.append(dec.build_compact_lattice(host, T, X_local[b]))
        return lats
