"""Recurrent neural network language model + lattice rescoring adapter.

Parity targets: src/rnnlm/ (RnnlmCoreTrainer, SamplingLm, and the
KaldiRnnlmDeterministicFst lattice-rescoring adapter — an on-demand
deterministic FST over RNNLM states).  The reference trains with
importance sampling to handle large vocabularies (rnnlm-get-sampling-lm
estimates a proposal LM; rnnlm-train draws negative samples from it and
importance-corrects the objective).  The equivalent here is
a sampled softmax: per step a shared candidate set is drawn by Gumbel
top-k from a unigram-power proposal INSIDE the jit (no host round
trip), and the output matmul runs over (K+1) gathered rows instead of
V — turning the V-wide softmax into an matmul-friendly skinny matmul.
Pass sample_k to train_rnnlm to enable; full softmax remains the
default (and the test oracle) for small vocabularies.

RnnLmScorer is the ConstArpa-shaped interface lattice/rescore.compose_lm
consumes: score(history, word) with an internal cache of RNN states
keyed by history prefix — exactly how the reference's deterministic FST
memoizes states per lattice path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax

from kaldi_tpu.core.logging import get_logger
from kaldi_tpu.fst.fst import SymbolTable

log = get_logger(__name__)


@dataclasses.dataclass
class RnnLmConfig:
    vocab_size: int = 100
    embed_dim: int = 64
    hidden_dim: int = 128


class RnnLm(nn.Module):
    config: RnnLmConfig

    def setup(self):
        cfg = self.config
        self.embed = nn.Embed(cfg.vocab_size, cfg.embed_dim, name="embed")
        ScanGRU = nn.scan(nn.GRUCell, variable_broadcast="params",
                          split_rngs={"params": False},
                          in_axes=1, out_axes=1)
        self.gru = ScanGRU(features=cfg.hidden_dim, name="gru")
        self.output = nn.Dense(cfg.vocab_size, name="output")

    def encode(self, tokens, carry=None):
        """tokens (B, T) int32 → (hidden states (B, T, H), final carry)."""
        emb = self.embed(tokens)
        if carry is None:
            carry = jnp.zeros((tokens.shape[0], self.config.hidden_dim))
        carry, hs = self.gru(carry, emb)
        return hs, carry

    def __call__(self, tokens, carry=None):
        """tokens (B, T) int32 → (logits (B, T, V), final carry)."""
        hs, carry = self.encode(tokens, carry)
        return self.output(hs), carry


def unigram_proposal(sentences: Sequence[Sequence[int]], vocab_size: int,
                     power: float = 0.75, eos: int = 2) -> np.ndarray:
    """Unigram^power proposal distribution for importance sampling — the
    SamplingLm role (src/rnnlm/sampling-lm.h estimates a backoff LM to
    propose negative samples; a flattened unigram is the standard
    static-proposal variant and keeps the draw fully on device)."""
    counts = np.ones(vocab_size, np.float64)      # add-1: all words live
    for s in sentences:
        for w in s:
            counts[w] += 1
        counts[eos] += 1
    q = counts ** power
    return (q / q.sum()).astype(np.float32)


def train_rnnlm(sentences: Sequence[Sequence[int]], cfg: RnnLmConfig,
                num_epochs: int = 20, batch_size: int = 16,
                learning_rate: float = 5e-3, bos: int = 1, eos: int = 2,
                seed: int = 0, sample_k: Optional[int] = None):
    """sentences: word-id sequences (without <s>/</s>; added here).
    sample_k: if set (and < vocab), train with importance-sampled
    softmax over sample_k shared Gumbel-top-k candidates per step
    instead of the full V-wide softmax.  Returns (params, model)."""
    model = RnnLm(cfg)
    rng = np.random.default_rng(seed)
    T = max(len(s) for s in sentences) + 1
    N = len(sentences)
    inp = np.zeros((N, T), np.int32)
    tgt = np.zeros((N, T), np.int32)
    mask = np.zeros((N, T), bool)
    for i, s in enumerate(sentences):
        seq = [bos] + list(s)
        out = list(s) + [eos]
        inp[i, :len(seq)] = seq
        tgt[i, :len(out)] = out
        mask[i, :len(out)] = True

    params = model.init(jax.random.PRNGKey(seed), inp[:2])["params"]
    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)
    use_sampling = sample_k is not None and sample_k < cfg.vocab_size
    log_q = jnp.asarray(np.log(unigram_proposal(sentences, cfg.vocab_size,
                                                eos=eos))) \
        if use_sampling else None

    @jax.jit
    def step(params, opt_state, xi, xt, xm, key):
        def loss_fn(p):
            if not use_sampling:
                logits, _ = model.apply({"params": p}, xi)
                lp = jax.nn.log_softmax(logits)
                nll = -jnp.take_along_axis(lp, xt[..., None], axis=2)[..., 0]
                return jnp.sum(jnp.where(xm, nll, 0.0)) / jnp.maximum(
                    jnp.sum(xm), 1)
            # sampled softmax: K shared candidates ~ q without
            # replacement (Gumbel top-k), logits over K+1 gathered
            # output rows, log(K·q) importance correction, accidental
            # hits masked (the candidate slot duplicating the target).
            hs, _ = model.apply({"params": p}, xi, method=RnnLm.encode)
            W = p["output"]["kernel"]                 # (H, V)
            b = p["output"]["bias"]                   # (V,)
            gumbel = jax.random.gumbel(key, (cfg.vocab_size,))
            _, cand = jax.lax.top_k(log_q + gumbel, sample_k)   # (K,)
            corr_c = jnp.log(float(sample_k)) + log_q[cand]
            logits_c = (jnp.einsum("bth,hk->btk", hs, W[:, cand])
                        + b[cand] - corr_c)           # (B, T, K)
            corr_t = jnp.log(float(sample_k)) + log_q[xt]
            logit_t = (jnp.einsum("bth,bth->bt", hs,
                                  W[:, xt].transpose(1, 2, 0))
                       + b[xt] - corr_t)              # (B, T)
            hit = cand[None, None, :] == xt[..., None]
            logits_c = jnp.where(hit, -jnp.inf, logits_c)
            denom = jnp.logaddexp(
                logit_t, jax.nn.logsumexp(logits_c, axis=-1))
            nll = denom - logit_t
            return jnp.sum(jnp.where(xm, nll, 0.0)) / jnp.maximum(
                jnp.sum(xm), 1)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    B = min(batch_size, N)
    key = jax.random.PRNGKey(seed + 1)
    for epoch in range(num_epochs):
        order = rng.permutation(N)
        tot, nb = 0.0, 0
        for i in range(0, N - B + 1, B):
            idx = order[i:i + B]
            key, sub = jax.random.split(key)
            params, opt_state, loss = step(params, opt_state,
                                           jnp.asarray(inp[idx]),
                                           jnp.asarray(tgt[idx]),
                                           jnp.asarray(mask[idx]), sub)
            tot += float(loss)
            nb += 1
        if epoch % 5 == 0 or epoch == num_epochs - 1:
            log.info("rnnlm epoch %d: nll/word %.3f (ppl %.1f)%s", epoch,
                     tot / max(nb, 1), float(np.exp(tot / max(nb, 1))),
                     " [sampled]" if use_sampling else "")
    return params, model


def perplexity(params, model: RnnLm, sentences: Sequence[Sequence[int]],
               bos: int = 1, eos: int = 2) -> float:
    """Exact (full-softmax) per-word perplexity of held-out sentences."""
    tot, n = 0.0, 0
    fwd = jax.jit(lambda p, x: model.apply({"params": p}, x)[0])
    for s in sentences:
        xi = jnp.asarray([[bos] + list(s)], jnp.int32)
        tgts = list(s) + [eos]
        lp = jax.nn.log_softmax(fwd(params, xi)[0])
        tot -= float(sum(lp[t, w] for t, w in enumerate(tgts)))
        n += len(tgts)
    return float(np.exp(tot / max(n, 1)))


class RnnLmScorer:
    """score(history_words, word) → log P, with RNN-state memoization
    (the KaldiRnnlmDeterministicFst role)."""

    def __init__(self, params, model: RnnLm, words: SymbolTable,
                 bos: str = "<s>", eos: str = "</s>",
                 backend: Optional[str] = None):
        """``backend``: the platform the single-token GRU step runs on
        (e.g. "cpu"); None = the JAX default device.  Lattice rescoring
        issues ONE step per unique history, so where the per-call
        latency of the default device dominates, "cpu" can win."""
        self.params = params
        self.model = model
        self.words = words
        self.bos = bos
        self.eos = eos
        self._cache: Dict[Tuple[str, ...], Tuple[np.ndarray, np.ndarray]] = {}

        def step(params, carry, token):
            logits, new_carry = model.apply({"params": params},
                                            token[None, None], carry)
            return jax.nn.log_softmax(logits[0, 0]), new_carry

        # committed params carry the step to the chosen device
        self._step = jax.jit(step)
        if backend is not None:
            self.params = jax.device_put(params, jax.devices(backend)[0])

    def _state_for(self, hist: Tuple[str, ...]):
        """(logprobs over next word, carry) after consuming hist."""
        if hist in self._cache:
            return self._cache[hist]
        if len(hist) == 0:
            raise ValueError("history must start with <s>")
        if len(hist) == 1:
            carry = jnp.zeros((1, self.model.config.hidden_dim))
            prev_lp = None
        else:
            prev_lp, carry = self._state_for(hist[:-1])
            carry = jnp.asarray(carry)
        tok = self.words.get(hist[-1], 0)
        lp, new_carry = self._step(self.params, carry,
                                   jnp.int32(tok))
        out = (np.asarray(lp), np.asarray(new_carry))
        self._cache[hist] = out
        return out

    def score(self, hist: Tuple[str, ...], word: str) -> float:
        """Natural-log P(word | hist); hist implicitly starts at <s>."""
        full_hist = hist if hist and hist[0] == self.bos \
            else (self.bos,) + tuple(hist)
        lp, _ = self._state_for(full_hist)
        wid = self.words.get(word, 0)
        return float(lp[wid])


def save_rnnlm(path: str, params, cfg: RnnLmConfig) -> None:
    """Token-framed RNNLM model file (<RnnLm> dims + flax msgpack
    payload; the rnnlm final.raw role)."""
    import flax.serialization
    from kaldi_tpu.core import io as kio
    blob = flax.serialization.to_bytes(params)
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<RnnLm>")
        for tok, v in (("<VocabSize>", cfg.vocab_size),
                       ("<EmbedDim>", cfg.embed_dim),
                       ("<HiddenDim>", cfg.hidden_dim),
                       ("<NumBytes>", len(blob))):
            kio.write_token(f, tok)
            kio.write_basic_int32(f, v)
        f.write(blob)
        kio.write_token(f, "</RnnLm>")


def load_rnnlm(path: str):
    """Returns (params, model)."""
    import flax.serialization
    from kaldi_tpu.core import io as kio
    from kaldi_tpu.core.logging import KaldiError
    with kio.open_rxfilename(path) as f:
        if not kio.init_kaldi_input_stream(f):
            raise KaldiError(f"{path}: not a binary kaldi file")
        kio.expect_token(f, "<RnnLm>")
        vals = []
        for tok in ("<VocabSize>", "<EmbedDim>", "<HiddenDim>",
                    "<NumBytes>"):
            kio.expect_token(f, tok)
            vals.append(kio.read_basic_int32(f))
        blob = f.read(vals[3])
        kio.expect_token(f, "</RnnLm>")
    cfg = RnnLmConfig(vocab_size=vals[0], embed_dim=vals[1],
                      hidden_dim=vals[2])
    model = RnnLm(cfg)
    dummy = model.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 2), jnp.int32))["params"]
    import flax.serialization as fser
    params = fser.from_bytes(dummy, blob)
    return params, model
