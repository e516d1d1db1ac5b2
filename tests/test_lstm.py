"""LSTM acoustic model: shapes, trainability, exact stateful streaming."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_tpu.am.lstm import LstmChain, LstmConfig, StreamingLstmScorer


@pytest.fixture(scope="module")
def model_and_params():
    cfg = LstmConfig(feat_dim=8, num_pdfs=12, hidden_dim=16, proj_dim=8,
                     num_layers=2, frame_subsampling_factor=3)
    model = LstmChain(cfg)
    x = jnp.zeros((2, 30, 8))
    variables = model.init(jax.random.PRNGKey(0), x)
    return model, variables["params"]


def test_lstm_shapes(model_and_params):
    model, params = model_and_params
    x = jnp.ones((2, 30, 8))
    out, carries = model.apply({"params": params}, x)
    assert out.shape == (2, 10, 12)
    assert len(carries) == 2
    c, h = carries[0]
    assert c.shape == (2, 16)


def test_lstm_streaming_exact(model_and_params, rng):
    """Carried-state chunked scoring equals the offline forward exactly
    (the looped-computation contract)."""
    model, params = model_and_params
    T = 60
    feats = rng.standard_normal((T, 8)).astype(np.float32)
    offline, _ = model.apply({"params": params},
                             jnp.asarray(feats[None]))
    offline = np.asarray(offline[0])

    sc = StreamingLstmScorer(params, model)
    outs = []
    for i in range(0, T, 12):        # 12 % 3 == 0
        outs.append(sc.accept_features(feats[i:i + 12]))
    streamed = np.concatenate(outs)
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, rtol=1e-5, atol=1e-5)
    # reset gives a fresh stream
    sc.reset()
    again = sc.accept_features(feats[:12])
    np.testing.assert_allclose(again, offline[:4], rtol=1e-5, atol=1e-5)


def test_lstm_gradients_flow(model_and_params, rng):
    model, params = model_and_params
    x = jnp.asarray(rng.standard_normal((2, 30, 8)).astype(np.float32))
    tgt = jnp.asarray(rng.integers(0, 12, (2, 10)))

    def loss(p):
        out, _ = model.apply({"params": p}, x)
        lp = jax.nn.log_softmax(out)
        return -jnp.mean(jnp.take_along_axis(lp, tgt[..., None], 2))

    g = jax.grad(loss)(params)
    norms = [float(jnp.abs(l).max()) for l in jax.tree_util.tree_leaves(g)]
    assert max(norms) > 0
    assert all(np.isfinite(n) for n in norms)


def test_restricted_attention_band(rng):
    """Attention outside the context band must have zero influence."""
    import flax.linen as nn
    from kaldi_tpu.am.xconfig import RestrictedAttentionLayer
    layer = RestrictedAttentionLayer(dim=8, num_heads=2, left_ctx=2,
                                     right_ctx=2)
    x = jnp.asarray(rng.standard_normal((1, 20, 8)).astype(np.float32))
    variables = layer.init(jax.random.PRNGKey(0), x)
    y0 = layer.apply(variables, x, mutable=["batch_stats"])[0]
    # perturb a frame far outside frame 10's band: no change at frame 10
    x2 = x.at[0, 16, :].add(100.0)
    y1 = layer.apply(variables, x2, mutable=["batch_stats"])[0]
    np.testing.assert_allclose(np.asarray(y0[0, 10]), np.asarray(y1[0, 10]),
                               atol=1e-4)
    # perturbing inside the band does change it
    x3 = x.at[0, 11, :].add(100.0)
    y2 = layer.apply(variables, x3, mutable=["batch_stats"])[0]
    assert np.abs(np.asarray(y2[0, 10]) - np.asarray(y0[0, 10])).max() > 1e-3
