"""Chain (LF-MMI) model training pipeline.

Parity target: steps/nnet3/chain/train.py + nnet3-chain-train
(SURVEY.md §3.4): egs preparation from GMM alignments, denominator
phone-LM graph, minibatch training.

One jit-compiled train step over a (data, model) mesh —
batch sharded on 'data', TDNN kernels optionally sharded on 'model';
gradient psum is inserted by XLA.  This replaces the reference's
N-jobs-with-model-averaging outer loop with true synchronous
data-parallel SGD (SURVEY.md §2.4 row 2).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kaldi_tpu.core.logging import KaldiError, get_logger
from kaldi_tpu.am.chain import (
    ChainTrainingOptions,
    DenominatorGraph,
    chain_objf,
    make_denominator_graph,
)
from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig, semi_orthogonal_penalty
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.transitions import TransitionModel
from kaldi_tpu.am.tree import MonophoneContextDependency
from kaldi_tpu.parallel.mesh import batch_sharding, make_mesh, shard_params

log = get_logger(__name__)


@dataclasses.dataclass
class ChainEgs:
    """Fixed-size training chunks (nnet3-chain-egs equivalent).

    entry_pdf/self_pdf/num_segs describe the chunk's phone-segment
    sequence for the flexible-boundary numerator (chain-supervision
    tolerance); pdf_ali is the fixed-path fallback.  entry_w/self_w/
    init_w/final_w are the normalization-FST weights (phone-LM + chain
    topology + den initial/final probs along the numerator chain)."""
    feats: np.ndarray       # (N, chunk_T, D)
    pdf_ali: np.ndarray     # (N, chunk_T // sub) int32
    mask: np.ndarray        # (N, chunk_T // sub) bool
    entry_pdf: np.ndarray = None   # (N, S_max) int32
    self_pdf: np.ndarray = None    # (N, S_max) int32
    num_segs: np.ndarray = None    # (N,) int32
    entry_w: np.ndarray = None     # (N, S_max) f32
    self_w: np.ndarray = None      # (N, S_max) f32
    init_w: np.ndarray = None      # (N,) f32
    final_w: np.ndarray = None     # (N,) f32
    # lattice-derived supervision: pack_supervisions() dict of padded
    # FSA tensors (am/chain_supervision.py); overrides both numerators
    sup: Dict[str, np.ndarray] = None


def make_chain_egs(feats: Dict[str, np.ndarray],
                   phone_alignments: Dict[str, List[Tuple[int, int]]],
                   tree, topo: HmmTopology,
                   chunk_size: int = 96, subsample: int = 3,
                   den=None) -> ChainEgs:
    """Cut utterances into fixed chunks; numerator pdfs from phone
    alignments ((phone, duration) runs) through the chain topology:
    first subsampled frame of a phone = forward pdf, rest = self pdf.

    When `den` (a DenominatorGraph with its PhoneLm) is given, each
    chunk also carries normalization-FST weights: per-segment LM +
    topology log-probs plus den initial/final probs, computed with the
    TRUE cross-chunk phone history (the reference's normalization FST
    applies the same weights during supervision composition —
    chain-supervision.h AddWeightToSupervisionFst)."""
    X, A, M, EP, NW = [], [], [], [], []
    out_T = chunk_size // subsample

    def dedup_runs(seq):
        out = []
        for p in seq:
            if not out or out[-1] != p:
                out.append(p)
        return out

    def norm_weights(segs, context_phones):
        """(entry_w, self_w, init_w, final_w) along the segment chain.
        Indexing is by LM state (norm_view) so the same computation
        serves monophone AND context-dependent den graphs (whose den
        states are (lm-state, left-phone) pairs)."""
        lm = den.lm
        nv_init, nv_self, nv_fwd, nv_final = den.norm_view()
        ew = np.zeros(out_T, np.float32)
        sw = np.zeros(out_T, np.float32)
        st = lm.state_of(context_phones)   # state of segment 0 (w/ history)
        init_w = den.initial_for(context_phones)
        sw[0] = nv_self[st]
        for i in range(1, len(segs)):
            c = lm.phones.index(segs[i])
            ew[i] = nv_fwd[st] + lm.next_logp[st, c]
            st = int(lm.next_state[st, c])
            sw[i] = nv_self[st]
        return ew, sw, np.float32(init_w), np.float32(nv_final[st])
    for u, f in sorted(feats.items()):
        # full-rate phone sequence, then subsample PHONES (midpoint rule)
        # and re-derive pdfs so every phone entry emits its forward pdf —
        # subsampling raw pdfs could skip a forward pdf, making numerator
        # sequences the denominator graph cannot produce.
        phones_full: List[int] = []
        for phone, dur in phone_alignments[u]:
            phones_full.extend([phone] * dur)
        T = min(len(phones_full), f.shape[0])
        T_sub_total = T // subsample
        sub_phones = [phones_full[min(subsample * t + subsample // 2, T - 1)]
                      for t in range(T_sub_total)]

        def pdfs_for(phone, is_entry, left=0, right=0):
            """pdf of a phone instance through the tree — with the TRUE
            phone context for context-dependent trees (left-biphone
            (2,1) is the chain build_tree.sh standard; (3,1) also
            supported on the numerator side)."""
            cw, cp = tree.context_width, tree.central_position
            if cw == 1:
                window = [phone]
            elif (cw, cp) == (2, 1):
                window = [left, phone]
            elif (cw, cp) == (3, 1):
                window = [left, phone, right]
            else:
                raise KaldiError(
                    f"make_chain_egs: unsupported tree context "
                    f"({cw},{cp})")
            st = topo.topology_for_phone(phone)[0]
            cls = (st.forward_pdf_class if is_entry
                   else st.self_loop_pdf_class)
            return tree.compute(window, cls)

        sub_pdfs_full = []
        prev_ph = 0
        for t, ph in enumerate(sub_phones):
            entry = t == 0 or sub_phones[t - 1] != ph
            if t > 0 and entry:
                prev_ph = sub_phones[t - 1]
            nxt = next((p for p in sub_phones[t + 1:] if p != ph), 0)
            sub_pdfs_full.append(pdfs_for(ph, entry, prev_ph, nxt))

        def segs_of(chunk_sub_phones):
            segs = []
            for t, ph in enumerate(chunk_sub_phones):
                if t == 0 or chunk_sub_phones[t - 1] != ph:
                    segs.append(ph)
            return segs

        def seg_arrays(chunk_sub_phones, left_ctx):
            """left_ctx: the phone instance preceding this chunk's
            first segment (0 at utterance start)."""
            segs = segs_of(chunk_sub_phones)
            e = np.zeros(out_T, np.int32)
            sl = np.zeros(out_T, np.int32)
            for i, ph in enumerate(segs):
                left = segs[i - 1] if i > 0 else left_ctx
                right = segs[i + 1] if i + 1 < len(segs) else 0
                e[i] = pdfs_for(ph, True, left, right)
                sl[i] = pdfs_for(ph, False, left, right)
            return e, sl, np.int32(len(segs))

        def left_ctx_of(start_sub):
            """Phone of the instance preceding the chunk's first
            segment's instance (0 at utterance start)."""
            first = sub_phones[start_sub] if start_sub < len(sub_phones) \
                else 0
            for t in range(start_sub - 1, -1, -1):
                if sub_phones[t] != first:
                    return sub_phones[t]
            return 0

        for start_sub in range(0, T_sub_total - out_T + 1, out_T):
            start = start_sub * subsample
            X.append(f[start:start + chunk_size])
            A.append(np.asarray(
                sub_pdfs_full[start_sub:start_sub + out_T], np.int32))
            M.append(np.ones(out_T, bool))
            chunk_phones = sub_phones[start_sub:start_sub + out_T]
            EP.append(seg_arrays(chunk_phones, left_ctx_of(start_sub)))
            if den is not None and den.lm is not None:
                NW.append(norm_weights(
                    segs_of(chunk_phones),
                    dedup_runs(sub_phones[:start_sub + 1])))
        rem_sub = T_sub_total % out_T
        if rem_sub >= 4:
            start_sub = T_sub_total - rem_sub
            start = start_sub * subsample
            chunk_f = np.zeros((chunk_size, f.shape[1]), f.dtype)
            chunk_f[:T - start] = f[start:T]
            sub_pdfs = np.zeros(out_T, np.int32)
            sp = sub_pdfs_full[start_sub:]
            sub_pdfs[:len(sp)] = sp
            m = np.zeros(out_T, bool)
            m[:len(sp)] = True
            X.append(chunk_f)
            A.append(sub_pdfs)
            M.append(m)
            EP.append(seg_arrays(sub_phones[start_sub:],
                                 left_ctx_of(start_sub)))
            if den is not None and den.lm is not None:
                NW.append(norm_weights(
                    segs_of(sub_phones[start_sub:]),
                    dedup_runs(sub_phones[:start_sub + 1])))
    kw = {}
    if NW:
        kw = dict(entry_w=np.stack([w[0] for w in NW]),
                  self_w=np.stack([w[1] for w in NW]),
                  init_w=np.asarray([w[2] for w in NW], np.float32),
                  final_w=np.asarray([w[3] for w in NW], np.float32))
    return ChainEgs(np.stack(X).astype(np.float32), np.stack(A),
                    np.stack(M),
                    entry_pdf=np.stack([e for e, _, _ in EP]),
                    self_pdf=np.stack([s_ for _, s_, _ in EP]),
                    num_segs=np.asarray([n for _, _, n in EP], np.int32),
                    **kw)


@dataclasses.dataclass
class ChainTrainConfig:
    num_epochs: int = 10
    batch_size: int = 16
    learning_rate: float = 1e-3
    final_learning_rate: float = 1e-4
    # Kaldi's per-component max-change (nnet3-train's key stabilizer):
    # each parameter tensor's update l2-norm is clamped to this value.
    # 0 disables.  Ref: src/nnet3/nnet-utils.h (ApplyMaxChange role).
    max_change: float = 2.0
    # exponential lr decay initial→final over this many steps (the
    # steps/nnet3/train.py effective-lrate schedule); None = derived
    # from num_epochs × batches at train() time, 0 = constant lr
    total_steps: Optional[int] = None
    orthonormal_weight: float = 1e-2
    # flexible-boundary supervision numerator (chain-supervision
    # tolerance, see am/chain.numerator_flexible_logprob); falls back to
    # the fixed alignment path when egs lack segment arrays
    use_flexible_numerator: bool = True
    # boundary tolerance (subsampled frames) for lattice-derived
    # supervision FSAs (egs.sup — chain-supervision's ±tolerance)
    supervision_tolerance: int = 1
    # "ngsgd" = natural-gradient SGD with momentum (the reference's
    # nnet3 default, ops/natural_gradient.py); "adamw" = plain adamw
    optimizer: str = "adamw"
    momentum: float = 0.9
    opts: ChainTrainingOptions = dataclasses.field(
        default_factory=ChainTrainingOptions)


class ChainTrainer:
    """Owns model/optimizer state and the compiled sharded train step."""

    def __init__(self, model_cfg, den: DenominatorGraph,
                 cfg: ChainTrainConfig = None, mesh: Optional[Mesh] = None,
                 seed: int = 0):
        """`model_cfg` is either a TdnnConfig (builds the native
        TdnnChain) or any module with the chain model contract —
        apply(vars, (B,T,feat_dim), train=) → (B, T//sub, num_pdfs)
        scores and a `feat_dim` attribute (e.g. xconfig-defined models,
        am/xconfig.chain_model_from_xconfig)."""
        self.cfg = cfg or ChainTrainConfig()
        self.model = (TdnnChain(model_cfg)
                      if isinstance(model_cfg, TdnnConfig) else model_cfg)
        self.den = den
        self.mesh = mesh
        rng = jax.random.PRNGKey(seed)
        dummy = jnp.zeros((2, 32, model_cfg.feat_dim))
        variables = self.model.init(rng, dummy, train=False)
        self.params = variables["params"]
        self.batch_stats = variables.get("batch_stats", {})
        self._build_tx(self.cfg.total_steps or 0)
        if mesh is not None:
            self.params = shard_params(self.params, mesh)
            self.opt_state = self.tx.init(self.params)
        self._trained_steps = 0
        self._step = jax.jit(self._train_step)

    def _build_tx(self, total_steps: int) -> None:
        """adamw + exponential lr decay + Kaldi-style per-component
        max-change clamping (the nnet3-train stabilizers)."""
        cfg = self.cfg
        if total_steps and cfg.final_learning_rate < cfg.learning_rate:
            lr = optax.exponential_decay(
                cfg.learning_rate, transition_steps=max(total_steps, 1),
                decay_rate=cfg.final_learning_rate / cfg.learning_rate)
        else:
            # always a schedule callable: keeps the opt-state STRUCTURE
            # identical whether or not decay is active, so checkpoints
            # restore across either configuration
            lr = optax.constant_schedule(cfg.learning_rate)
        if cfg.optimizer == "ngsgd":
            from kaldi_tpu.ops.natural_gradient import ngsgd
            chain_tx = [ngsgd(lr, momentum=cfg.momentum)]
        else:
            chain_tx = [optax.adamw(lr)]
        if cfg.max_change > 0:
            mc = cfg.max_change

            def clamp_updates(updates, state, params=None):
                def clamp(u):
                    n = jnp.sqrt(jnp.sum(jnp.square(u)) + 1e-20)
                    return u * jnp.minimum(1.0, mc / n)
                return (jax.tree_util.tree_map(clamp, updates), state)

            chain_tx.append(optax.GradientTransformation(
                lambda params: optax.EmptyState(), clamp_updates))
        self.tx = optax.chain(*chain_tx)
        self.opt_state = self.tx.init(self.params)

    def _loss_fn(self, params, batch_stats, feats, pdf_ali, mask,
                 num_graph, sup=None):
        scores, updates = self.model.apply(
            {"params": params, "batch_stats": batch_stats},
            feats, train=True, mutable=["batch_stats"])
        num_fsa = ((sup, self.cfg.supervision_tolerance)
                   if sup is not None else None)
        loss, diag = chain_objf(self.den, scores, pdf_ali, mask,
                                self.cfg.opts, num_graph=num_graph,
                                num_fsa=num_fsa)
        loss = loss + self.cfg.orthonormal_weight * \
            semi_orthogonal_penalty(params)
        return loss, (diag, updates["batch_stats"])

    def _train_step(self, params, batch_stats, opt_state, feats, pdf_ali,
                    mask, num_graph=None, sup=None):
        if self.mesh is not None:
            feats = jax.lax.with_sharding_constraint(
                feats, batch_sharding(self.mesh))
        (loss, (diag, new_bs)), grads = jax.value_and_grad(
            self._loss_fn, has_aux=True)(params, batch_stats, feats,
                                         pdf_ali, mask, num_graph, sup)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_bs, opt_state, loss, diag

    # -- checkpoint / resume (steps/nnet3 N.mdl + --stage contract) --------
    def save(self, ckpt_dir: str, step: int) -> None:
        from kaldi_tpu.pipelines.checkpoint import save_train_state
        save_train_state(ckpt_dir, step, self.params, self.batch_stats,
                         self.opt_state)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        from kaldi_tpu.pipelines.checkpoint import restore_train_state
        template = {
            "step": np.asarray(0),
            "params": jax.tree_util.tree_map(np.asarray, self.params),
            "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                  dict(self.batch_stats)),
            "opt_state": jax.tree_util.tree_map(np.asarray, self.opt_state),
        }
        try:
            state = restore_train_state(ckpt_dir, template, step)
        except Exception as e:
            raise type(e)(
                f"{e}\n(note: ngsgd optimizer-state layout gained a "
                "step counter in round 4 — checkpoints written by "
                "older ngsgd runs cannot be resumed; adamw "
                "checkpoints are unaffected)") from e
        self.params = state["params"]
        self.batch_stats = state["batch_stats"]
        self.opt_state = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(self.opt_state),
            jax.tree_util.tree_leaves(state["opt_state"]))
        self._trained_steps = int(state["step"])
        return int(state["step"])

    def train(self, egs: ChainEgs, log_every: int = 20,
              ckpt_dir: Optional[str] = None) -> Dict[str, float]:
        N = egs.feats.shape[0]
        B = min(self.cfg.batch_size, N)
        if self.cfg.total_steps is None and self._trained_steps == 0:
            # derive the lr-decay horizon now that the eg count is known
            self._build_tx(self.cfg.num_epochs * max(N // B, 1))
        rng = np.random.default_rng(0)
        step = 0
        last: Dict[str, float] = {}
        for epoch in range(self.cfg.num_epochs):
            order = rng.permutation(N)
            for i in range(0, N - B + 1, B):
                idx = order[i:i + B]
                num_graph = None
                sup = None
                if egs.sup is not None:
                    sup = {k: jnp.asarray(v[idx])
                           for k, v in egs.sup.items()}
                elif (self.cfg.use_flexible_numerator
                        and egs.entry_pdf is not None):
                    num_graph = (jnp.asarray(egs.entry_pdf[idx]),
                                 jnp.asarray(egs.self_pdf[idx]),
                                 jnp.asarray(egs.num_segs[idx]))
                    if egs.entry_w is not None:
                        num_graph = num_graph + (
                            jnp.asarray(egs.entry_w[idx]),
                            jnp.asarray(egs.self_w[idx]),
                            jnp.asarray(egs.init_w[idx]),
                            jnp.asarray(egs.final_w[idx]))
                (self.params, self.batch_stats, self.opt_state, loss,
                 diag) = self._step(self.params, self.batch_stats,
                                    self.opt_state,
                                    jnp.asarray(egs.feats[idx]),
                                    jnp.asarray(egs.pdf_ali[idx]),
                                    jnp.asarray(egs.mask[idx]),
                                    num_graph, sup)
                step += 1
                self._trained_steps += 1
                if step % log_every == 0:
                    log.info("chain step %d: loss %.4f objf %.4f "
                             "(num %.3f den %.3f)", step, float(loss),
                             float(diag["objf"]), float(diag["num"]),
                             float(diag["den"]))
            last = {"loss": float(loss), "objf": float(diag["objf"])}
            if ckpt_dir is not None:
                self.save(ckpt_dir, step)
        return last

    # -- inference ---------------------------------------------------------
    def scores_fn(self):
        """Jitted (B, T, D) → (B, T/sub, P) scorer for decoding."""
        @jax.jit
        def f(params, batch_stats, feats):
            return self.model.apply(
                {"params": params, "batch_stats": batch_stats},
                feats, train=False)
        return partial(f, self.params, self.batch_stats)


def build_chain_tree(feats: Dict[str, np.ndarray],
                     alignments: Dict[str, Sequence[int]],
                     tm: TransitionModel, topo: HmmTopology,
                     num_leaves: int,
                     context_width: int = 2, central_position: int = 1):
    """Context-dependent decision tree over the CHAIN topology from GMM
    alignments — steps/nnet3/chain/build_tree.sh.  The (2,1)
    left-biphone default is the reference's standard chain-tree
    configuration (e2e/aishell/multi_en chain recipes pass
    --context-width=2 --central-position=1); it keeps the denominator
    graph near phone-LM size (see am/chain.py
    _make_den_graph_biphone).

    Stats: per aligned frame, window = phone context of the instance,
    pdf-class = the chain topology's forward class on the instance's
    first frame and its self-loop class after (the 3-state GMM
    alignment collapses onto the 2-class chain topology by frame
    position, matching how build_tree.sh re-accumulates stats under
    the new topology)."""
    from kaldi_tpu.am.tree import GaussStats, build_tree
    from kaldi_tpu.pipelines.tri import _frame_info, \
        cluster_phone_questions
    stats: Dict[Tuple[Tuple[int, ...], int], GaussStats] = {}
    for u, tids in alignments.items():
        f = np.asarray(feats[u], np.float64)
        info = _frame_info(tm, tids)
        phones: List[int] = []
        for pi, ph, st in info:
            if pi == len(phones):
                phones.append(ph)
        prev_pi = -1
        for t, (pi, ph, hmm_state) in enumerate(info):
            if t >= f.shape[0]:
                break
            window = []
            for off in range(-central_position,
                             context_width - central_position):
                j = pi + off
                window.append(phones[j] if 0 <= j < len(phones) else 0)
            entry = topo.topology_for_phone(ph)[0]
            pc = (entry.forward_pdf_class if pi != prev_pi
                  else entry.self_loop_pdf_class)
            prev_pi = pi
            key = (tuple(window), pc)
            if key not in stats:
                stats[key] = GaussStats(f.shape[1])
            stats[key].accumulate(f[t])
    questions = cluster_phone_questions(stats, central_position)
    tree = build_tree(stats, questions, context_width, central_position,
                      max_leaves=num_leaves)
    log.info("build_chain_tree: %d leaves over %d (window, class) "
             "events (context %d,%d)", tree.num_pdfs, len(stats),
             context_width, central_position)
    return tree


def phone_alignment_runs(tm: TransitionModel, tids: Sequence[int]
                         ) -> List[Tuple[int, int]]:
    """tid alignment → [(phone, duration in frames)] runs
    (ali-to-phones --write-lengths equivalent)."""
    runs: List[Tuple[int, int]] = []
    for tid in tids:
        phone = tm.transition_id_to_phone(tid)
        is_initial = (tm.transition_id_to_hmm_state(tid) == 0
                      and not tm.is_self_loop(tid))
        if is_initial or not runs:
            runs.append((phone, 1))
        else:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
    return runs
