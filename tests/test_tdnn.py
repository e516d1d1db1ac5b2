"""Plain-JAX TDNN-F against its float64 NumPy reference, and the leaf
names the sharding rules, converters and checkpoints rely on."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig, forward_numpy
from kaldi_tpu.parallel.mesh import make_mesh, shard_params

CFG = TdnnConfig(feat_dim=12, num_pdfs=16, hidden_dim=32,
                 bottleneck_dim=8, num_layers=5,
                 frame_subsampling_factor=3)


def _variables(rng, cfg=CFG):
    x = rng.standard_normal((3, 30, cfg.feat_dim)).astype(np.float32)
    v = TdnnChain(cfg).init(jax.random.PRNGKey(0), x)
    # output_affine starts at zero; plant random weights and running
    # stats so the comparison exercises every layer
    k = v["params"]["output_affine"]["kernel"]
    v["params"]["output_affine"]["kernel"] = jnp.asarray(
        rng.standard_normal(k.shape) * 0.2, jnp.float32)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.abs(rng.standard_normal(a.shape)) + 0.5,
                              jnp.float32), v["batch_stats"])
    return x, v


def test_tdnn_tree_keeps_leaf_names(rng):
    _, v = _variables(rng)
    p, s = v["params"], v["batch_stats"]
    assert set(p) == {"input_affine", "prefinal", "output_affine"} | {
        f"tdnnf{i}" for i in range(1, CFG.num_layers + 1)}
    assert set(p["tdnnf1"]) == {"linear", "affine"}
    assert set(p["tdnnf1"]["linear"]) == {"kernel"}
    assert set(p["tdnnf1"]["affine"]) == {"kernel", "bias"}
    assert set(s) == {"input_bn", "prefinal_bn"} | {
        f"tdnnf{i}" for i in range(1, CFG.num_layers + 1)}
    assert set(s["tdnnf3"]["batchnorm"]) == {"mean", "var"}
    assert p["input_affine"]["kernel"].shape == (3 * CFG.feat_dim, 32)
    assert p["tdnnf4"]["linear"]["kernel"].shape == (2 * 32, 8)


def test_tdnn_eval_matches_numpy_float64(rng):
    x, v = _variables(rng)
    with jax.default_matmul_precision("highest"):
        got = np.asarray(TdnnChain(CFG).apply(v, x, train=False))
    ref, stats = forward_numpy(CFG, v, x, train=False)
    assert got.shape == (3, 10, CFG.num_pdfs)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    # inference leaves the running averages alone
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(v["batch_stats"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-7)


def test_tdnn_train_updates_batch_stats(rng):
    x, v = _variables(rng)
    model = TdnnChain(CFG)
    with jax.default_matmul_precision("highest"):
        got, upd = model.apply(v, x, train=True, mutable=["batch_stats"])
    ref, ref_stats = forward_numpy(CFG, v, x, train=True)
    got = np.asarray(got)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    new = upd["batch_stats"]
    assert (jax.tree_util.tree_structure(new)
            == jax.tree_util.tree_structure(v["batch_stats"]))
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(ref_stats)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4, atol=1e-5)
    moved = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(jax.tree_util.tree_leaves(new),
                             jax.tree_util.tree_leaves(v["batch_stats"]))]
    assert min(moved) > 0


def test_tdnn_bf16_close_to_f32(rng):
    x, v = _variables(rng)
    o32 = np.asarray(TdnnChain(CFG).apply(v, x))
    cfg16 = TdnnConfig(**{**CFG.__dict__, "compute_dtype": "bfloat16"})
    o16 = np.asarray(TdnnChain(cfg16).apply(v, x))
    assert o16.dtype == np.float32
    assert np.abs(o16 - o32).max() <= 5e-2 * np.abs(o32).max()


def test_shard_params_2x2_follows_leaf_names(rng):
    """On a (data=2, model=2) mesh, TDNN-F 'affine' kernels shard their
    input rows and 'linear' kernels their output columns over 'model'
    — which needs the leaf names to have survived."""
    _, v = _variables(rng)
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    sp = shard_params(v["params"], mesh)
    for i in range(1, CFG.num_layers + 1):
        layer = sp[f"tdnnf{i}"]
        assert layer["affine"]["kernel"].sharding.spec == P("model", None)
        assert layer["linear"]["kernel"].sharding.spec == P(None, "model")
        assert layer["affine"]["bias"].sharding.spec == P()
        assert len(layer["affine"]["kernel"].sharding.device_set) == 4
    assert sp["input_affine"]["kernel"].sharding.spec == P(None, "model")
    for a, b in zip(jax.tree_util.tree_leaves(sp),
                    jax.tree_util.tree_leaves(v["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
