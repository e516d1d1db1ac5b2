"""TDNN + chain objective tests.

Oracles: brute-force NumPy forward algorithm for the denominator
(the pattern of src/chain/chain-supervision-test.cc: forward-backward
totals checked against direct path enumeration), gradient checks via
jax.grad vs finite differences, and a learnability check (objf rises)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_tpu.am.chain import (
    ChainTrainingOptions,
    DenominatorGraph,
    chain_objf,
    denominator_logprob,
    make_denominator_graph,
    numerator_logprob,
    numpy_den_forward,
)
from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig, semi_orthogonal_penalty
from kaldi_tpu.am.topology import HmmTopology
from kaldi_tpu.am.tree import MonophoneContextDependency


def test_tdnn_shapes():
    cfg = TdnnConfig(feat_dim=12, num_pdfs=20, hidden_dim=32,
                     bottleneck_dim=8, num_layers=4,
                     frame_subsampling_factor=3)
    model = TdnnChain(cfg)
    x = jnp.zeros((2, 30, 12))
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    out = model.apply(variables, x, train=False)
    assert out.shape == (2, 10, 20)
    pen = semi_orthogonal_penalty(variables["params"])
    assert float(pen) >= 0


def _tiny_den():
    # 2 states; self-loops + cross arcs; pdfs 0..3
    return DenominatorGraph(
        num_states=2,
        src=np.array([0, 0, 1, 1], np.int32),
        dst=np.array([0, 1, 1, 0], np.int32),
        pdf=np.array([0, 1, 2, 3], np.int32),
        logw=np.log(np.array([0.6, 0.4, 0.7, 0.3], np.float32)),
        initial=np.log(np.array([0.5, 0.5], np.float32)),
        final=np.log(np.array([0.5, 0.5], np.float32)),
    )


def test_denominator_matches_numpy_oracle(rng):
    den = _tiny_den()
    scores = rng.standard_normal((3, 7, 4)).astype(np.float32)
    got = np.asarray(denominator_logprob(den, jnp.asarray(scores)))
    ref = numpy_den_forward(den, scores)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_denominator_grad_is_posterior(rng):
    """d logZ / d score sums to 1 per frame (occupancy posteriors)."""
    den = _tiny_den()
    scores = jnp.asarray(rng.standard_normal((2, 6, 4)).astype(np.float32))
    g = jax.grad(lambda s: jnp.sum(denominator_logprob(den, s)))(scores)
    per_frame = np.asarray(g).sum(axis=2)
    np.testing.assert_allclose(per_frame, 1.0, atol=1e-4)


def test_numerator_gather(rng):
    scores = jnp.asarray(rng.standard_normal((2, 5, 4)).astype(np.float32))
    ali = jnp.asarray(np.array([[0, 1, 2, 3, 0], [1, 1, 1, 1, 1]]))
    mask = jnp.asarray(np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool))
    got = np.asarray(numerator_logprob(scores, ali, mask))
    s = np.asarray(scores)
    ref0 = sum(s[0, t, [0, 1, 2, 3, 0][t]] for t in range(5))
    ref1 = sum(s[1, t, 1] for t in range(3))
    np.testing.assert_allclose(got, [ref0, ref1], rtol=1e-5)


def test_make_denominator_graph():
    phones = [1, 2, 3]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    seqs = [[1, 2, 3], [1, 3], [2, 2, 1]]
    den = make_denominator_graph(seqs, tree, topo)
    assert den.num_states == 3
    # every state has a self-loop and P outgoing cross arcs
    assert len(den.src) == 3 + 9
    # all pdfs valid
    assert den.pdf.max() < tree.num_pdfs
    # initial/final normalized-ish
    assert abs(np.exp(den.initial).sum() - 1.0) < 1e-5


def test_chain_objective_learnable(rng):
    """A linear scorer trained on the chain objective must separate a
    planted alignment: objf should increase substantially."""
    phones = [1, 2]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    den = make_denominator_graph([[1, 2, 1], [2, 1, 2]], tree, topo)
    P = tree.num_pdfs
    B, T, D = 4, 20, 8
    # numerator alignments must be VALID den-graph paths (num ⊆ den):
    # sample them as random walks over the den arcs.
    arcs_of = {}
    for s, d2, p, w in zip(den.src, den.dst, den.pdf, den.logw):
        arcs_of.setdefault(int(s), []).append((int(d2), int(p), float(w)))
    self_pdf = {s: max((a for a in arcs if a[0] == s), key=lambda a: a[2])[1]
                for s, arcs in arcs_of.items()}
    ali = np.zeros((B, T), np.int32)
    for b in range(B):
        state = int(rng.integers(den.num_states))
        ali[b, 0] = self_pdf[state]
        for t in range(1, T):
            arcs = arcs_of[state]
            probs = np.exp([a[2] for a in arcs])
            k = int(rng.choice(len(arcs), p=probs / probs.sum()))
            state, pdf, _ = arcs[k]
            ali[b, t] = pdf
    # data: features are one-hot-ish per pdf
    proto = rng.standard_normal((P, D)).astype(np.float32)
    feats = proto[ali] + 0.1 * rng.standard_normal((B, T, D)).astype(np.float32)
    mask = np.ones((B, T), bool)

    W = jnp.zeros((D, P))

    def loss_fn(W):
        scores = feats @ W
        return chain_objf(den, scores, jnp.asarray(ali), jnp.asarray(mask),
                          ChainTrainingOptions(l2_regularize=0.0))

    loss0, diag0 = loss_fn(W)
    g = jax.grad(lambda w: loss_fn(w)[0])
    for _ in range(60):
        W = W - 0.5 * g(W)
    loss1, diag1 = loss_fn(W)
    assert float(diag1["objf"]) > float(diag0["objf"]) + 0.5
    # As scores separate perfectly, den → best-path = num + path weights,
    # so objf/frame is bounded by the worst per-frame transition cost
    # (self-loop log 2; cross arcs add the bigram LM term ≈ log 2·|P|).
    worst_arc = -float(np.min(den.logw[den.logw > -5.0]))
    assert float(diag1["objf"]) <= worst_arc + 3.0 / T


def test_flexible_numerator_bounds(rng):
    """Flexible-boundary numerator: ≥ any fixed segmentation path, ≤ the
    denominator-free sum over all segmentations (sanity via brute force
    on a tiny case)."""
    import itertools
    from kaldi_tpu.am.chain import numerator_flexible_logprob
    B, T, P = 1, 5, 4
    scores = jnp.asarray(rng.standard_normal((B, T, P)).astype(np.float32))
    # 2 segments: entry pdfs [0, 2], self pdfs [1, 3]
    entry = jnp.asarray([[0, 2, 0, 0, 0]], jnp.int32)
    selfp = jnp.asarray([[1, 3, 0, 0, 0]], jnp.int32)
    nseg = jnp.asarray([2], jnp.int32)
    mask = jnp.ones((B, T), bool)
    got = float(numerator_flexible_logprob(scores, entry, selfp, nseg, mask)[0])
    # brute force: boundary b = first frame of segment 2, 1..T-1; frame 0
    # emits entry-or-self of segment 1 (logaddexp)
    s = np.asarray(scores[0])
    totals = []
    for b in range(1, T):
        v = np.logaddexp(s[0, 0], s[0, 1])
        for t in range(1, b):
            v += s[t, 1]
        v += s[b, 2]
        for t in range(b + 1, T):
            v += s[t, 3]
        totals.append(v)
    ref = np.logaddexp.reduce(totals)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_flexible_numerator_in_training(rng):
    """Training with the flexible numerator must still learn (objf up)."""
    from kaldi_tpu.am.topology import HmmTopology
    from kaldi_tpu.am.tree import MonophoneContextDependency
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.pipelines.chain import (ChainTrainConfig, ChainTrainer,
                                           make_chain_egs)
    phones = [1, 2]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    den = make_denominator_graph([[1, 2, 1], [2, 1, 2]], tree, topo)
    # fabricate alignments: phone runs with durations
    runs = {"u0": [(1, 12), (2, 12), (1, 12)],
            "u1": [(2, 12), (1, 12), (2, 12)]}
    D = 6
    proto = {1: rng.standard_normal(D), 2: rng.standard_normal(D)}
    feats = {}
    for u, rr in runs.items():
        fs = []
        for ph, dur in rr:
            fs.extend([proto[ph] + 0.1 * rng.standard_normal(D)
                       for _ in range(dur)])
        feats[u] = np.asarray(fs, np.float32)
    egs = make_chain_egs(feats, runs, tree, topo, chunk_size=18, subsample=3)
    assert egs.entry_pdf is not None
    assert egs.num_segs.min() >= 1
    cfg = TdnnConfig(feat_dim=D, num_pdfs=tree.num_pdfs, hidden_dim=16,
                     bottleneck_dim=8, num_layers=2,
                     frame_subsampling_factor=3)
    tr = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=30, batch_size=4, learning_rate=5e-3,
        use_flexible_numerator=True))
    out = tr.train(egs, log_every=1000)
    assert np.isfinite(out["loss"])
    assert out["objf"] > -5.0   # learned something reasonable


# ---------------------------------------------------------------------------
# Round-2 chain parity: leaky-HMM, mask, n-gram den LM, normalization
# ---------------------------------------------------------------------------

def test_denominator_mask_equals_truncation(rng):
    """Masked padded frames must not contribute denominator mass: the
    masked logZ equals logZ of the truncated sequence."""
    den = _tiny_den()
    scores = rng.standard_normal((2, 9, 4)).astype(np.float32)
    mask = np.ones((2, 9), bool)
    mask[0, 5:] = False
    mask[1, 7:] = False
    got = np.asarray(denominator_logprob(den, jnp.asarray(scores),
                                         mask=jnp.asarray(mask)))
    ref0 = numpy_den_forward(den, scores[:1, :5])[0]
    ref1 = numpy_den_forward(den, scores[1:, :7])[0]
    np.testing.assert_allclose(got, [ref0, ref1], rtol=1e-4, atol=1e-4)


def _numpy_leaky_forward(den, scores, leaky):
    """Oracle with the leak applied after every alpha update."""
    B, T, P = scores.shape
    S = den.num_states
    self_pdf = np.zeros(S, np.int32)
    entry_pdf = np.zeros(S, np.int32)
    for a in range(len(den.src)):
        if den.src[a] == den.dst[a]:
            self_pdf[den.src[a]] = den.pdf[a]
        else:
            entry_pdf[den.dst[a]] = den.pdf[a]
    init = np.exp(den.initial)
    out = np.zeros(B)
    for b in range(B):
        alpha = np.exp(den.initial + np.logaddexp(scores[b, 0, self_pdf],
                                                  scores[b, 0, entry_pdf]))
        alpha = alpha + leaky * init * alpha.sum()
        scale = 0.0
        for t in range(1, T):
            new = np.zeros(S)
            for a in range(len(den.src)):
                new[den.dst[a]] += alpha[den.src[a]] * math.exp(
                    den.logw[a] + scores[b, t, den.pdf[a]])
            alpha = new + leaky * init * new.sum()
            scale += math.log(alpha.max())
            alpha = alpha / alpha.max()
        out[b] = scale + math.log((alpha * np.exp(den.final)).sum())
    return out


def test_leaky_hmm_matches_oracle(rng):
    """Leaky-HMM: exact match vs a numpy forward oracle; logZ strictly
    grows with the coefficient (more paths), continuously from 0;
    occupancies stay proper posteriors (sum to 1)."""
    den = _tiny_den()
    T = 8
    scores = jnp.asarray(rng.standard_normal((2, T, 4)).astype(np.float32))
    z0 = np.asarray(denominator_logprob(den, scores))
    z1 = np.asarray(denominator_logprob(den, scores,
                                        leaky_hmm_coefficient=0.1))
    ref1 = _numpy_leaky_forward(den, np.asarray(scores), 0.1)
    np.testing.assert_allclose(z1, ref1, rtol=1e-4, atol=1e-4)
    z2 = np.asarray(denominator_logprob(den, scores,
                                        leaky_hmm_coefficient=0.3))
    zeps = np.asarray(denominator_logprob(den, scores,
                                          leaky_hmm_coefficient=1e-7))
    assert np.all(z1 > z0) and np.all(z2 > z1)
    np.testing.assert_allclose(zeps, z0, atol=1e-4)
    g = jax.grad(lambda s: jnp.sum(denominator_logprob(
        den, s, leaky_hmm_coefficient=0.1)))(scores)
    per_frame = np.asarray(g).sum(axis=2)
    np.testing.assert_allclose(per_frame, 1.0, atol=1e-4)
    # occupancies bounded in [0, 1]
    assert np.asarray(g).min() >= -1e-6
    assert np.asarray(g).max() <= 1.0 + 1e-6


def test_trigram_den_graph_normalized():
    """Order-3 den graph: per-state outgoing mass (self + cross + final)
    is exactly 1, states cover every unigram history, and the graph is
    strictly bigger than the bigram one on the same data."""
    from kaldi_tpu.am.chain import estimate_phone_lm
    phones = [1, 2, 3]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    seqs = [[1, 2, 3, 1, 2], [2, 1, 3, 3], [1, 2, 1, 2, 3], [3, 1, 2]]
    den2 = make_denominator_graph(seqs, tree, topo, order=2)
    den3 = make_denominator_graph(seqs, tree, topo, order=3)
    assert den2.num_states == 3
    assert den3.num_states > den2.num_states
    for den in (den2, den3):
        mass = np.zeros(den.num_states)
        np.add.at(mass, den.src, np.exp(den.logw))
        mass += np.exp(den.final)
        np.testing.assert_allclose(mass, 1.0, atol=1e-4)
        # stationary initial distribution normalized
        np.testing.assert_allclose(np.exp(den.initial).sum(), 1.0, atol=1e-4)
    # trigram LM must fit held-in data at least as well as bigram
    lm2 = estimate_phone_lm(seqs, phones, order=2)
    lm3 = estimate_phone_lm(seqs, phones, order=3)

    def lm_logprob(lm, seq):
        st = lm.state_of(seq[:1])
        lp = 0.0
        for p in seq[1:]:
            c = lm.phones.index(p)
            lp += lm.next_logp[st, c]
            st = int(lm.next_state[st, c])
        return lp + lm.final_logp[st]

    tot2 = sum(lm_logprob(lm2, s) for s in seqs)
    tot3 = sum(lm_logprob(lm3, s) for s in seqs)
    assert tot3 > tot2 - 1e-6


def test_normalization_weights_make_objf_nonpositive(rng):
    """With normalization-FST weights on the numerator, num ⊆ den as
    weighted sets, so objf = (num − den)/frames ≤ 0 for ANY scores."""
    from kaldi_tpu.pipelines.chain import make_chain_egs
    phones = [1, 2]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    seqs = [[1, 2, 1], [2, 1, 2], [1, 1, 2]]
    den = make_denominator_graph(seqs, tree, topo, order=2)
    runs = {"u0": [(1, 9), (2, 9), (1, 9)], "u1": [(2, 9), (1, 9), (2, 9)]}
    D = 4
    feats = {u: rng.standard_normal((27, D)).astype(np.float32)
             for u in runs}
    egs = make_chain_egs(feats, runs, tree, topo, chunk_size=27,
                         subsample=3, den=den)
    assert egs.entry_w is not None
    for trial in range(3):
        scores = jnp.asarray(rng.standard_normal(
            (egs.feats.shape[0], 9, tree.num_pdfs)).astype(np.float32) * 3)
        num_graph = (jnp.asarray(egs.entry_pdf), jnp.asarray(egs.self_pdf),
                     jnp.asarray(egs.num_segs), jnp.asarray(egs.entry_w),
                     jnp.asarray(egs.self_w), jnp.asarray(egs.init_w),
                     jnp.asarray(egs.final_w))
        _, diag = chain_objf(den, scores, None, jnp.asarray(egs.mask),
                             ChainTrainingOptions(l2_regularize=0.0,
                                                  leaky_hmm_coefficient=0.0),
                             num_graph=num_graph)
        assert float(diag["objf"]) <= 1e-5


def test_max_change_clamps_update_norms(rng):
    """nnet3-train's per-component max-change: every parameter tensor's
    applied update has l2 norm <= max_change even under huge gradients,
    and the lr schedule decays toward final_learning_rate."""
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    phones = [1, 2]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    den = make_denominator_graph([[1, 2, 1]], tree, topo)
    cfg = TdnnConfig(feat_dim=4, num_pdfs=tree.num_pdfs, hidden_dim=8,
                     bottleneck_dim=4, num_layers=2,
                     frame_subsampling_factor=3)
    mc = 0.05
    tr = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=1, batch_size=2, learning_rate=100.0,
        max_change=mc, total_steps=10, use_flexible_numerator=False))
    before = jax.tree_util.tree_map(np.asarray, tr.params)
    feats = jnp.asarray(
        1e3 * rng.standard_normal((2, 12, 4)).astype(np.float32))
    pdf_ali = jnp.zeros((2, 4), jnp.int32)
    mask = jnp.ones((2, 4), jnp.float32)
    (tr.params, tr.batch_stats, tr.opt_state, loss, diag) = tr._step(
        tr.params, tr.batch_stats, tr.opt_state, feats, pdf_ali, mask,
        None)
    after = jax.tree_util.tree_map(np.asarray, tr.params)
    deltas = jax.tree_util.tree_map(lambda a, b: b - a, before, after)
    for leaf in jax.tree_util.tree_leaves(deltas):
        assert np.linalg.norm(leaf) <= mc + 1e-5
    # schedule: optax exponential_decay reaches final lr at total_steps
    import optax
    sched = optax.exponential_decay(1e-3, transition_steps=10,
                                    decay_rate=1e-4 / 1e-3)
    assert math.isclose(float(sched(10)), 1e-4, rel_tol=1e-5)


def test_chain_trainer_ngsgd_step(rng):
    """optimizer="ngsgd" (natural-gradient SGD, the reference's nnet3
    default) takes finite steps that move the params and respects
    max-change clamping."""
    from kaldi_tpu.am.tdnn import TdnnConfig
    from kaldi_tpu.pipelines.chain import ChainTrainConfig, ChainTrainer
    phones = [1, 2]
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    den = make_denominator_graph([[1, 2, 1]], tree, topo)
    cfg = TdnnConfig(feat_dim=4, num_pdfs=tree.num_pdfs, hidden_dim=8,
                     bottleneck_dim=4, num_layers=2,
                     frame_subsampling_factor=3)
    mc = 0.5
    tr = ChainTrainer(cfg, den, ChainTrainConfig(
        num_epochs=1, batch_size=2, learning_rate=1e-2, max_change=mc,
        total_steps=10, use_flexible_numerator=False,
        optimizer="ngsgd"))
    before = jax.tree_util.tree_map(np.asarray, tr.params)
    feats = jnp.asarray(rng.standard_normal((2, 12, 4)).astype(np.float32))
    pdf_ali = jnp.zeros((2, 4), jnp.int32)
    mask = jnp.ones((2, 4), jnp.float32)
    for _ in range(3):
        (tr.params, tr.batch_stats, tr.opt_state, loss, diag) = tr._step(
            tr.params, tr.batch_stats, tr.opt_state, feats, pdf_ali, mask,
            None)
    assert np.isfinite(float(loss))
    after = jax.tree_util.tree_map(np.asarray, tr.params)
    moved = 0.0
    for b, a in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        assert np.all(np.isfinite(a))
        assert np.linalg.norm(a - b) <= 3 * mc + 1e-5
        moved += float(np.linalg.norm(a - b))
    assert moved > 0.0


def test_denominator_dense_matches_scatter():
    """The dense (S,S)-matmul denominator recursion must equal the
    scatter segment-op formulation in value AND gradient (the dense
    path is the fast path; scatter is the oracle)."""
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.am.chain import denominator_logprob
    rng = np.random.default_rng(9)
    topo = HmmTopology.chain([1, 2, 3, 4])
    tree = MonophoneContextDependency([1, 2, 3, 4], topo)
    seqs = [list(rng.integers(1, 5, 12)) for _ in range(30)]
    den = make_denominator_graph(seqs, tree, topo, order=3)
    B, T = 3, 9
    scores = jnp.asarray(
        rng.standard_normal((B, T, tree.num_pdfs)), jnp.float32)
    mask = jnp.asarray(rng.random((B, T)) > 0.2)
    mask = mask.at[:, 0].set(True)

    def f_dense(s):
        return jnp.sum(denominator_logprob(
            den, s, mask, leaky_hmm_coefficient=1e-3,
            dense_state_limit=10000))

    def f_scatter(s):
        return jnp.sum(denominator_logprob(
            den, s, mask, leaky_hmm_coefficient=1e-3,
            dense_state_limit=0))

    vd, gd = jax.value_and_grad(f_dense)(scores)
    vs, gs = jax.value_and_grad(f_scatter)(scores)
    assert float(vd) == pytest.approx(float(vs), abs=2e-3)
    np.testing.assert_allclose(np.asarray(gd), np.asarray(gs),
                               atol=2e-3)
