"""Regression-tree MLLR: mean-transform adaptation with a binary tree
of Gaussian classes.

Parity target: the reference's RegressionTree + RegtreeMllrDiagGmm
(src/transform/regression-tree.h, regtree-mllr-diag-gmm.h): Gaussians
are clustered into base classes; each tree node holds an affine
mean transform μ' = W μ⁺ (W is D×(D+1)); stats accumulate at the base
classes and are summed up the tree; a node estimates its own W only
when its subtree occupancy ≥ min_count, otherwise it inherits the
deepest sufficiently-occupied ancestor's.  Unlike fMLLR the transform
acts on MODEL MEANS, so each row has a closed-form solve (no log-det
term): W_i = K_i G_i⁻¹ with
  K_i  = Σ_m Σ_t γ_m(t)·x_i(t)/σ²_m,i · μ⁺_mᵀ
  G_i  = Σ_m γ_m        /σ²_m,i · μ⁺_m μ⁺_mᵀ.

Shape: accumulation is one vectorized einsum pass over
(T, M) posteriors (no per-frame loops); the tree walk is tiny host
code.  Gaussian clustering uses 2-means splitting on means — the
reference clusters with its own Clusterable machinery; the tree
CONTRACT (occupancy-gated per-class transforms) is what matters.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from kaldi_tpu.core.logging import get_logger

log = get_logger(__name__)


class RegressionTree:
    """Binary tree over the flattened (pdf, mix) Gaussian set.

    nodes: 0 is the root; children[n] = (l, r) or None for leaves;
    bclass[g] = leaf node id of flat Gaussian g (only valid Gaussians
    — weight > 0 — are assigned; padded mixture slots map to -1).
    """

    def __init__(self, children: List[Optional[Tuple[int, int]]],
                 bclass: np.ndarray, num_pdfs: int, max_mix: int):
        self.children = children
        self.bclass = bclass        # (num_pdfs * max_mix,) int32
        self.num_pdfs = num_pdfs
        self.max_mix = max_mix

    @property
    def num_nodes(self) -> int:
        return len(self.children)

    def parents(self) -> np.ndarray:
        par = np.full(self.num_nodes, -1, np.int32)
        for n, ch in enumerate(self.children):
            if ch is not None:
                par[ch[0]] = n
                par[ch[1]] = n
        return par

    @staticmethod
    def build(am, num_base_classes: int = 4, seed: int = 0
              ) -> "RegressionTree":
        """Cluster valid Gaussians by their means into ≤num_base_classes
        leaves via recursive 2-means splitting (largest-cluster first)."""
        P, M, D = am.means.shape
        valid = am.weights.reshape(-1) > 0
        means = am.means.reshape(-1, D)
        rng = np.random.default_rng(seed)
        idx_all = np.nonzero(valid)[0]

        children: List[Optional[Tuple[int, int]]] = [None]
        members: Dict[int, np.ndarray] = {0: idx_all}
        leaves = [0]
        while len(leaves) < num_base_classes:
            # split the most populous splittable leaf
            leaves.sort(key=lambda n: -len(members[n]))
            node = next((n for n in leaves if len(members[n]) >= 2), None)
            if node is None:
                break
            pts = means[members[node]]
            # 2-means
            c = pts[rng.choice(len(pts), 2, replace=False)]
            for _ in range(10):
                d2 = ((pts[:, None, :] - c[None]) ** 2).sum(-1)
                assign = d2.argmin(1)
                if len(np.unique(assign)) < 2:
                    assign[rng.integers(len(assign))] = 1 - assign[0]
                c = np.stack([pts[assign == k].mean(0) for k in (0, 1)])
            l, r = len(children), len(children) + 1
            children.extend([None, None])
            children[node] = (l, r)
            members[l] = members[node][assign == 0]
            members[r] = members[node][assign == 1]
            del members[node]
            leaves.remove(node)
            leaves.extend([l, r])
        bclass = np.full(P * M, -1, np.int32)
        for n in leaves:
            bclass[members[n]] = n
        log.info("RegressionTree: %d base classes over %d gaussians",
                 len(leaves), len(idx_all))
        return RegressionTree(children, bclass, P, M)


class RegtreeMllrAccs:
    """Per-base-class K/G accumulators (RegtreeMllrDiagGmmAccs role)."""

    def __init__(self, tree: RegressionTree, dim: int):
        self.tree = tree
        N = tree.num_nodes
        self.K = np.zeros((N, dim, dim + 1))
        self.G = np.zeros((N, dim, dim + 1, dim + 1))
        self.beta = np.zeros(N)

    def accumulate(self, am, feats: np.ndarray, pdf_ali: np.ndarray
                   ) -> None:
        """One vectorized pass: mixture posteriors for the aligned pdfs,
        scattered into each Gaussian's base class."""
        post = np.asarray(am.component_posteriors(feats, pdf_ali))  # (T,M)
        T, M = post.shape
        D = feats.shape[1]
        x = np.asarray(feats, np.float64)
        mu = am.means[pdf_ali]                        # (T, M, D)
        iv = 1.0 / am.vars[pdf_ali]                   # (T, M, D)
        mup = np.concatenate([mu, np.ones((T, M, 1))], axis=2)  # (T,M,D+1)
        g = post[:, :, None] * iv                     # (T, M, D) γ/σ²
        cls = self.tree.bclass[pdf_ali[:, None] * self.tree.max_mix
                               + np.arange(M)[None, :]]          # (T, M)
        for b in np.unique(cls[cls >= 0]):
            sel = cls == b                                        # (T, M)
            gs = np.where(sel, post, 0.0)
            gv = np.where(sel[:, :, None], g, 0.0)                # (T,M,D)
            # K_i += Σ γ/σ²_i x_i μ⁺ᵀ
            self.K[b] += np.einsum("tmi,ti,tmj->ij", gv, x, mup)
            # G_i += Σ γ/σ²_i μ⁺ μ⁺ᵀ
            self.G[b] += np.einsum("tmi,tmj,tmk->ijk", gv, mup, mup)
            self.beta[b] += gs.sum()

    def estimate(self, min_count: float = 100.0) -> "RegtreeMllr":
        """Sum stats bottom-up; estimate W per node when its subtree
        occupancy ≥ min_count; leaves inherit the deepest estimable
        ancestor (root falls back to identity)."""
        tree = self.tree
        N = tree.num_nodes
        D = self.K.shape[1]
        par = tree.parents()
        K = self.K.copy()
        G = self.G.copy()
        beta = self.beta.copy()
        # bottom-up: children were appended after parents, so reverse
        # index order visits children first
        for n in range(N - 1, 0, -1):
            K[par[n]] += K[n]
            G[par[n]] += G[n]
            beta[par[n]] += beta[n]

        ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)

        def solve(n: int) -> np.ndarray:
            W = np.empty((D, D + 1))
            for i in range(D):
                Gi = G[n, i] + 1e-6 * np.eye(D + 1) * (
                    np.trace(G[n, i]) / (D + 1) + 1)
                W[i] = np.linalg.solve(Gi, K[n, i])
            return W

        Ws: List[np.ndarray] = [None] * N  # type: ignore[list-item]
        order = list(range(N))  # parents first (construction order)
        for n in order:
            if beta[n] >= min_count:
                Ws[n] = solve(n)
            else:
                Ws[n] = Ws[par[n]] if par[n] >= 0 else ident
        used = sum(1 for n in order if beta[n] >= min_count)
        log.info("RegtreeMllr: estimated %d/%d node transforms "
                 "(min-count %.0f)", used, N, min_count)
        return RegtreeMllr(tree, np.stack(Ws))

    def merge(self, other: "RegtreeMllrAccs") -> "RegtreeMllrAccs":
        self.K += other.K
        self.G += other.G
        self.beta += other.beta
        return self


class RegtreeMllr:
    """Estimated per-node transforms; applies to model means."""

    def __init__(self, tree: RegressionTree, W: np.ndarray):
        self.tree = tree
        self.W = W                                    # (N, D, D+1)

    def transform_model(self, am):
        """Return a copy of `am` with means replaced by W μ⁺ per each
        Gaussian's base class (gmm-est-regtree-mllr → decode flow)."""
        import copy
        out = copy.deepcopy(am)
        P, M, D = am.means.shape
        flat = am.means.reshape(-1, D)
        mup = np.concatenate([flat, np.ones((len(flat), 1))], axis=1)
        cls = self.tree.bclass
        newm = flat.copy()
        ok = cls >= 0
        # μ' = W μ⁺, batched per class
        for b in np.unique(cls[ok]):
            sel = ok & (cls == b)
            newm[sel] = mup[sel] @ self.W[b].T
        out.means = newm.reshape(P, M, D)
        out.refresh()
        return out


def write_regtree(path: str, tree: RegressionTree) -> None:
    """Serialize a regression tree (RegressionTree::Write role) with
    the package's Kaldi-style token framing."""
    from kaldi_tpu.core import io as kio
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<REGTREE>")
        kio.write_basic_int32(f, tree.num_pdfs)
        kio.write_basic_int32(f, tree.max_mix)
        kio.write_basic_int32(f, tree.num_nodes)
        for ch in tree.children:
            if ch is None:
                kio.write_basic_int32(f, -1)
                kio.write_basic_int32(f, -1)
            else:
                kio.write_basic_int32(f, ch[0])
                kio.write_basic_int32(f, ch[1])
        kio.write_int_vector(f, tree.bclass.astype(np.int32))
        kio.write_token(f, "</REGTREE>")


def read_regtree(path: str) -> RegressionTree:
    from kaldi_tpu.core import io as kio
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise ValueError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<REGTREE>")
        num_pdfs = kio.read_basic_int32(f)
        max_mix = kio.read_basic_int32(f)
        n = kio.read_basic_int32(f)
        children = []
        for _ in range(n):
            l = kio.read_basic_int32(f)
            r = kio.read_basic_int32(f)
            children.append(None if l < 0 else (l, r))
        bclass = np.asarray(kio.read_int_vector(f), np.int32)
        kio.expect_token(f, "</REGTREE>")
    return RegressionTree(children, bclass, num_pdfs, max_mix)


class RegtreeFmllrAccs:
    """Per-base-class fMLLR accumulators (RegtreeFmllrDiagGmmAccs —
    src/transform/regtree-fmllr-diag-gmm.h): the FmllrAccs K/G stats
    gathered separately per regression-tree node, summed bottom-up at
    estimate time with occupancy gating, so sparse classes inherit the
    deepest estimable ancestor's FEATURE transform."""

    def __init__(self, tree: RegressionTree, dim: int):
        self.tree = tree
        N = tree.num_nodes
        self.K = np.zeros((N, dim, dim + 1))
        self.G = np.zeros((N, dim, dim + 1, dim + 1))
        self.beta = np.zeros(N)

    def accumulate(self, am, feats: np.ndarray, pdf_ali: np.ndarray
                   ) -> None:
        post = np.asarray(am.component_posteriors(feats, pdf_ali))
        T, M = post.shape
        D = feats.shape[1]
        x = np.asarray(feats, np.float64)
        xp = np.concatenate([x, np.ones((T, 1))], axis=1)   # (T, D+1)
        mu = am.means[pdf_ali]
        iv = 1.0 / am.vars[pdf_ali]
        g = post[:, :, None] * iv                            # (T, M, D)
        cls = self.tree.bclass[pdf_ali[:, None] * self.tree.max_mix
                               + np.arange(M)[None, :]]
        for b in np.unique(cls[cls >= 0]):
            sel = cls == b
            gv = np.where(sel[:, :, None], g, 0.0)
            gm = gv * mu                                     # γ/σ² μ
            self.K[b] += np.einsum("tmi,tj->ij", gm, xp)
            self.G[b] += np.einsum("tmi,tj,tk->ijk", gv, xp, xp)
            self.beta[b] += np.where(sel, post, 0.0).sum()

    def merge(self, other: "RegtreeFmllrAccs") -> "RegtreeFmllrAccs":
        self.K += other.K
        self.G += other.G
        self.beta += other.beta
        return self

    def estimate(self, min_count: float = 200.0) -> "RegtreeFmllr":
        from kaldi_tpu.am.transforms import FmllrAccs
        tree = self.tree
        N = tree.num_nodes
        D = self.K.shape[1]
        par = tree.parents()
        K, G, beta = self.K.copy(), self.G.copy(), self.beta.copy()
        for n in range(N - 1, 0, -1):
            K[par[n]] += K[n]
            G[par[n]] += G[n]
            beta[par[n]] += beta[n]
        ident = np.concatenate([np.eye(D), np.zeros((D, 1))], axis=1)
        Ws: List[np.ndarray] = [None] * N  # type: ignore[list-item]
        for n in range(N):
            if beta[n] >= min_count:
                accs = FmllrAccs(D)
                accs.K, accs.G, accs.beta = K[n], G[n], float(beta[n])
                Ws[n], _impr = accs.update(min_count=min_count)
            else:
                Ws[n] = Ws[par[n]] if par[n] >= 0 else ident
        used = int((beta >= min_count).sum())
        log.info("RegtreeFmllr: estimated %d/%d node transforms", used, N)
        return RegtreeFmllr(tree, np.stack(Ws))


class RegtreeFmllr:
    """Per-node FEATURE transforms; apply() picks each frame's
    transform by the aligned pdf's dominant base class — or use
    W[0] (the root) as a plain speaker transform."""

    def __init__(self, tree: RegressionTree, W: np.ndarray):
        self.tree = tree
        self.W = W                                    # (N, D, D+1)

    def root_transform(self) -> np.ndarray:
        return self.W[0]
