"""Time-height convolution (am/cnn.py) — numpy direct-convolution
oracle (the cu-matrix-test pattern), height subsampling, and the
conv-relu-batchnorm-layer xconfig line (CNN-TDNN front ends)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_tpu.am.cnn import TimeHeightConv


def conv_oracle(x, kernel, bias, height_in, t_offs, h_offs, sub):
    """Direct-sum reference: out[b,t,h,f] = Σ_{dt,dh,c}
    x[b,t+dt,h*sub+dh,c]·K[dt,dh,c,f], zero-padded out of range."""
    B, T, D = x.shape
    cin = D // height_in
    img = x.reshape(B, T, height_in, cin)
    hout = (height_in - 1) // sub + 1
    F = kernel.shape[-1]
    out = np.zeros((B, T, hout, F), np.float32)
    for b in range(B):
        for t in range(T):
            for h in range(hout):
                acc = np.zeros(F, np.float32)
                for i, dt in enumerate(t_offs):
                    for j, dh in enumerate(h_offs):
                        ts, hs = t + dt, h * sub + dh
                        if 0 <= ts < T and 0 <= hs < height_in:
                            acc += img[b, ts, hs] @ kernel[i, j]
                out[b, t, h] = acc + bias
    return out.reshape(B, T, hout * F)


@pytest.mark.parametrize("sub,h_offs", [(1, (-1, 0, 1)), (2, (0, 1))])
def test_time_height_conv_matches_oracle(sub, h_offs):
    rng = np.random.default_rng(0)
    B, T, H, cin, F = 2, 9, 8, 3, 4
    x = jnp.asarray(rng.standard_normal((B, T, H * cin)), jnp.float32)
    layer = TimeHeightConv(height_in=H, num_filters_out=F,
                           time_offsets=(-2, -1, 0, 1, 2),
                           height_offsets=h_offs, height_subsample=sub)
    variables = layer.init(jax.random.PRNGKey(0), x)
    out, hout = layer.apply(variables, x)
    k = np.asarray(variables["params"]["kernel"])
    b = np.asarray(variables["params"]["bias"])
    ref = conv_oracle(np.asarray(x), k, b, H, (-2, -1, 0, 1, 2),
                      h_offs, sub)
    assert out.shape == ref.shape
    assert hout == (H - 1) // sub + 1
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-4)


def test_noncontiguous_offsets_rejected():
    x = jnp.zeros((1, 4, 8), jnp.float32)
    layer = TimeHeightConv(height_in=4, num_filters_out=2,
                           time_offsets=(-3, 0, 3))
    with pytest.raises(ValueError):
        layer.init(jax.random.PRNGKey(0), x)


def test_xconfig_cnn_tdnnf_front_end():
    """The CNN-TDNN recipe shape: conv front end (with height
    subsampling) feeding a TDNN-F trunk, via xconfig."""
    from kaldi_tpu.am.xconfig import model_from_xconfig
    text = """
input name=input dim=40
conv-relu-batchnorm-layer name=cnn1 height-in=40 num-filters-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1
conv-relu-batchnorm-layer name=cnn2 height-in=40 num-filters-out=8 time-offsets=-1,0,1 height-offsets=-1,0,1 height-subsample-out=2
tdnnf-layer name=tdnnf3 dim=32 bottleneck-dim=8 time-stride=1
output-layer name=output dim=20 include-log-softmax=false
"""
    model, in_dim, out_dims = model_from_xconfig(text)
    x = jnp.asarray(np.random.default_rng(1)
                    .standard_normal((2, 11, 40)), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), x)
    outs = model.apply(variables, x)
    assert outs["output"].shape == (2, 11, 20)
    # cnn1: 40 heights × 8 filters = 320; cnn2 subsamples height ×2:
    # 20 heights × 8 filters = 160 → tdnnf3 input
    k = variables["params"]["tdnnf3"]["linear"]["kernel"]
    assert k.shape[0] == 2 * 160   # two splice taps × 160


def test_tdnn_bfloat16_compute_matches_f32():
    """compute_dtype="bfloat16" runs the half-precision matmul path with params in
    f32: outputs stay close to the f32 reference and argmax rarely
    moves (mixed-precision inference contract)."""
    import jax
    from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig
    rng = np.random.default_rng(0)
    base = dict(feat_dim=24, num_pdfs=64, hidden_dim=64,
                bottleneck_dim=16, num_layers=3,
                frame_subsampling_factor=3)
    m32 = TdnnChain(TdnnConfig(**base))
    m16 = TdnnChain(TdnnConfig(**base, compute_dtype="bfloat16"))
    x = jnp.asarray(rng.standard_normal((2, 30, 24)), jnp.float32)
    v = m32.init(jax.random.PRNGKey(0), x)
    # zero-init output layer makes outputs 0; plant a random kernel
    params = jax.tree_util.tree_map(lambda a: a, v["params"])
    params["output_affine"] = {
        "kernel": jnp.asarray(rng.standard_normal(
            params["output_affine"]["kernel"].shape) * 0.1, jnp.float32),
        "bias": params["output_affine"]["bias"]}
    vv = {"params": params, "batch_stats": v["batch_stats"]}
    o32 = np.asarray(m32.apply(vv, x))
    o16 = np.asarray(m16.apply(vv, x))
    assert o16.dtype == np.float32        # outputs come back f32
    scale = np.abs(o32).max() + 1e-6
    assert np.abs(o16 - o32).max() / scale < 0.05
    agree = (o16.argmax(-1) == o32.argmax(-1)).mean()
    assert agree > 0.9
