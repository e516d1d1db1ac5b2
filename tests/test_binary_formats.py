"""Upstream binary-format readers: OpenFst FSTs, CompressedMatrix,
nnet3 model files.

Oracles: write→read round-trips (byte verification against real
upstream artifacts is pending a populated reference mount —
SURVEY.md §0); decode-equivalence after an FST round-trip; TDNN-F
score equality after an nnet3 export→import cycle.
"""

import io

import numpy as np
import pytest

from kaldi_tpu.core import io as kio
from kaldi_tpu.fst.fst import Arc, VectorFst
from kaldi_tpu.fst.openfst_io import (read_fst, write_const_fst,
                                      write_vector_fst)


def _random_fst(rng, n_states=30, n_arcs=80):
    fst = VectorFst()
    for _ in range(n_states):
        fst.add_state()
    fst.set_start(0)
    for _ in range(n_arcs):
        s = int(rng.integers(n_states))
        fst.add_arc(s, Arc(int(rng.integers(0, 10)),
                           int(rng.integers(0, 10)),
                           float(rng.standard_normal()),
                           int(rng.integers(n_states))))
    for s in rng.choice(n_states, 5, replace=False):
        fst.set_final(int(s), float(rng.random()))
    return fst


def _fst_equal(a, b):
    assert a.num_states == b.num_states
    assert a.start == b.start
    assert dict(a.finals) == pytest.approx(dict(b.finals))
    for s in range(a.num_states):
        aa = [(x.ilabel, x.olabel, x.nextstate, x.weight)
              for x in a.arcs[s]]
        bb = [(x.ilabel, x.olabel, x.nextstate, x.weight)
              for x in b.arcs[s]]
        assert len(aa) == len(bb)
        for x, y in zip(aa, bb):
            assert x[:3] == y[:3]
            assert abs(x[3] - y[3]) < 1e-6


@pytest.mark.parametrize("writer", [write_vector_fst, write_const_fst])
def test_openfst_roundtrip(rng, writer):
    fst = _random_fst(rng)
    buf = io.BytesIO()
    writer(buf, fst)
    buf.seek(0)
    got = read_fst(buf)
    _fst_equal(fst, got)


def test_openfst_bad_magic():
    from kaldi_tpu.core.logging import KaldiError
    buf = io.BytesIO(b"\x00\x01\x02\x03rest")
    with pytest.raises(KaldiError):
        read_fst(buf)


def test_binary_hclg_decodes(rng, tmp_path):
    """A binary OpenFst HCLG file decodes identically to the in-memory
    graph (the gmm-latgen-faster binary-input contract)."""
    from kaldi_tpu.am import (HmmTopology, MonophoneContextDependency,
                              TransitionModel)
    from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig
    from kaldi_tpu.fst import (ArpaModel, Lang, Lexicon, arpa_to_fst,
                               make_unigram_arpa, mkgraph)
    from kaldi_tpu.fst.csr import pack_fst
    from kaldi_tpu.fst.openfst_io import read_fst_path

    lex = Lexicon(entries=[("YES", ["Y", "EH", "S"]), ("NO", ["N", "OW"])])
    lang = Lang(lex)
    phones = lang.phone_list()
    topo = HmmTopology.chain(phones)
    tree = MonophoneContextDependency(phones, topo)
    tm = TransitionModel(topo, tree)
    arpa = ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0}))
    HCLG = mkgraph(lang, tm, arpa_to_fst(arpa, lang.words))
    path = str(tmp_path / "HCLG.fst")
    with open(path, "wb") as f:
        write_const_fst(f, HCLG)
    loaded = read_fst_path(path)
    ll = rng.standard_normal((25, tm.num_pdfs)).astype(np.float32)
    cfg = BeamDecoderConfig(beam=1e9, max_active=10 ** 9,
                            acoustic_scale=0.1)
    d1 = BeamDecoder(pack_fst(HCLG), tm.tid_to_pdf_array, cfg)
    d2 = BeamDecoder(pack_fst(loaded), tm.tid_to_pdf_array, cfg)
    t1, o1, c1 = d1.decode(ll)
    t2, o2, c2 = d2.decode(ll)
    assert t1 == t2 and o1 == o2 and abs(c1 - c2) < 1e-4


@pytest.mark.parametrize("fmt,tol", [("CM", 0.03), ("CM2", 1e-3),
                                     ("CM3", 0.03)])
def test_compressed_matrix_roundtrip(rng, fmt, tol):
    mat = rng.standard_normal((50, 13)).astype(np.float32) * 4
    buf = io.BytesIO()
    kio.write_compressed_matrix(buf, mat, fmt=fmt)
    buf.seek(0)
    got = kio.read_compressed_matrix(buf)
    rng_span = mat.max() - mat.min()
    assert np.abs(got - mat).max() < tol * rng_span
    # read_matrix dispatches CM tokens too
    buf.seek(0)
    got2 = kio.read_matrix(buf)
    np.testing.assert_allclose(got, got2)


def test_compressed_matrix_outliers(rng):
    """Per-column percentile bands keep precision when one column has
    a huge outlier (the point of the CM format over flat CM3)."""
    mat = rng.standard_normal((200, 4)).astype(np.float32)
    mat[0, 0] = 500.0
    buf = io.BytesIO()
    kio.write_compressed_matrix(buf, mat, fmt="CM")
    buf.seek(0)
    got = kio.read_compressed_matrix(buf)
    # entries below the column's 75th percentile keep fine precision
    # (only the [p75, outlier] band quantizes coarsely — as upstream)
    p75 = np.quantile(mat[:, 0], 0.75)
    sel = mat[:, 0] < p75
    assert np.abs(got[sel, 0] - mat[sel, 0]).max() < 0.05


def test_nnet3_roundtrip_scores(rng, tmp_path):
    """Export TDNN-F to an nnet3 .raw file, read it back, and
    verify identical scores."""
    import jax
    import jax.numpy as jnp
    from kaldi_tpu.am.nnet3_io import read_raw_model, write_raw_model
    from kaldi_tpu.am.tdnn import TdnnChain, TdnnConfig

    cfg = TdnnConfig(feat_dim=8, num_pdfs=10, hidden_dim=16,
                     bottleneck_dim=4, num_layers=3,
                     frame_subsampling_factor=3)
    model = TdnnChain(cfg)
    x = jnp.asarray(rng.standard_normal((2, 24, 8)).astype(np.float32))
    variables = model.init(jax.random.PRNGKey(0), x, train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    bstats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])

    path = str(tmp_path / "final.raw")
    write_raw_model(path, params, bstats, cfg)
    p2, b2 = read_raw_model(path, cfg)

    ref = model.apply(variables, x, train=False)
    got = model.apply({"params": p2, "batch_stats": b2}, x, train=False)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_nnet3_generic_fields(rng):
    """The generic reader keeps unknown fields raw and preserves them
    through a write→read→write cycle."""
    from kaldi_tpu.am.nnet3_io import (FieldValue, Nnet3Component,
                                       Nnet3Model, read_nnet3,
                                       write_nnet3, _f32, _i32, _b,
                                       _mat, _vec)
    comp = Nnet3Component("weird.layer", "SomeFutureComponent", {
        "Dim": _i32(7),
        "SomethingNew": _f32(0.25),
        "AFlag": _b(False),
        "BigParams": _mat(rng.standard_normal((3, 5))),
        "SmallVec": _vec(rng.standard_normal(4)),
    })
    m = Nnet3Model(["input-node name=input dim=7"], [comp])
    buf = io.BytesIO()
    write_nnet3(buf, m)
    buf.seek(0)
    m2 = read_nnet3(buf)
    c2 = m2.components[0]
    assert c2.name == "weird.layer"
    assert c2.ctype == "SomeFutureComponent"
    assert c2.fields["Dim"].as_int == 7
    assert abs(c2.fields["SomethingNew"].as_float - 0.25) < 1e-7
    assert c2.fields["AFlag"].as_bool is False
    np.testing.assert_allclose(c2.fields["BigParams"].array,
                               comp.fields["BigParams"].array, rtol=1e-6)
    assert m2.config_lines == m.config_lines


def test_copy_feats_compress_roundtrip(rng, tmp_path):
    """copy-feats --compress writes CM archives that read back through
    the normal mat holder (the steps/make_mfcc.sh --compress contract)."""
    from kaldi_tpu.cli.tools import TOOLS
    from kaldi_tpu.core.table import SequentialTableReader, TableWriter
    feats = {f"utt{i}": rng.standard_normal((30 + i, 13)).astype(np.float32)
             for i in range(3)}
    raw = tmp_path / "raw.ark"
    comp = tmp_path / "comp.ark"
    with TableWriter(f"ark:{raw}", holder="mat") as w:
        for k, v in feats.items():
            w[k] = v
    rc = TOOLS["copy-feats"]([f"--compress=true", f"ark:{raw}",
                              f"ark:{comp}"])
    assert rc == 0
    assert comp.stat().st_size < raw.stat().st_size / 2.5
    got = dict(SequentialTableReader(f"ark:{comp}", holder="mat"))
    assert sorted(got) == sorted(feats)
    for k in feats:
        span = feats[k].max() - feats[k].min()
        assert np.abs(got[k] - feats[k]).max() < 0.01 * span
