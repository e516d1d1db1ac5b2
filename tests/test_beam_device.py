"""BeamDecoder's device-facing policies: the device β-prune memory
budget follows the device's reported memory limit, and a failure of the
device-side record compaction surfaces instead of being replaced by a
slower fetch."""

import jax
import numpy as np
import pytest

from kaldi_tpu.am import HmmTopology, MonophoneContextDependency, \
    TransitionModel
from kaldi_tpu.decoder import beam
from kaldi_tpu.decoder.beam import BeamDecoder, BeamDecoderConfig
from kaldi_tpu.fst import ArpaModel, Lang, Lexicon, arpa_to_fst, \
    make_unigram_arpa, mkgraph
from kaldi_tpu.fst.csr import pack_fst


@pytest.fixture(scope="module")
def small_decoder():
    lex = Lexicon(entries=[("YES", ["Y", "EH", "S"]), ("NO", ["N", "OW"])])
    lang = Lang(lex)
    topo = HmmTopology.chain(lang.phone_list())
    tree = MonophoneContextDependency(lang.phone_list(), topo)
    tm = TransitionModel(topo, tree)
    arpa = ArpaModel.parse(make_unigram_arpa({"YES": 1.0, "NO": 1.0}))
    csr = pack_fst(mkgraph(lang, tm, arpa_to_fst(arpa, lang.words),
                           self_loop_scale=1.0))
    dec = BeamDecoder(csr, tm.tid_to_pdf_array, BeamDecoderConfig(
        beam=16.0, max_active=200, acoustic_scale=1.0, lattice_beam=6.0,
        lattice_arcs_per_frame=512))
    return dec, tm


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats, expect", [
    ({"bytes_limit": 80 << 30, "bytes_in_use": 0},
     int((80 << 30) * beam.BETA_MEMORY_FRACTION)),
    (None, beam.BETA_FIXED_BUDGET),
    ({"bytes_in_use": 0}, beam.BETA_FIXED_BUDGET),
])
def test_beta_budget_follows_bytes_limit(stats, expect):
    budget, source = beam.beta_memory_budget(_Device(stats))
    assert budget == expect
    assert source.startswith("fixed") == (expect == beam.BETA_FIXED_BUDGET)


def test_beta_budget_on_cpu_is_fixed(small_decoder, monkeypatch):
    """The CPU backend reports no bytes_limit: the fixed budget gates
    the β-prune, and a device that reports a small limit turns it
    off for a shape that no longer fits."""
    dec, _ = small_decoder
    cpu = jax.devices("cpu")[0]
    assert beam.beta_memory_budget(cpu)[0] == beam.BETA_FIXED_BUDGET
    shape = (4, 64, dec.num_pdfs)
    assert dec._use_beta(shape)
    need = 4 * 64 * 4 * (dec.L * (2 * dec._recw + 1) + dec.K)
    small = {"bytes_limit": int(need / beam.BETA_MEMORY_FRACTION) - 1024}
    monkeypatch.setattr(beam, "_default_device",
                        lambda: _Device(small))
    assert not dec._use_beta(shape)


def test_failing_compaction_raises(small_decoder, monkeypatch):
    """_fetch_batch has no silent fallback: a failing device-side
    compaction raises out of it (and out of the batch decode)."""
    dec, tm = small_decoder
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2, 16, tm.num_pdfs)).astype(np.float32)
    lens = np.array([16, 12], np.int32)
    ok = dec.decode_compact_batch(X, lens)
    assert len(ok) == 2

    def broken(*a, **k):
        raise RuntimeError("compaction failed")

    monkeypatch.setattr(dec, "_compact_gather", broken)
    out = dec._decode_batch_jit(dec._graph_arrays(), X, lens)
    with pytest.raises(RuntimeError, match="compaction failed"):
        dec._fetch_batch(out, 2, lattice=True)
    with pytest.raises(RuntimeError, match="compaction failed"):
        dec.decode_compact_batch(X, lens)


def test_background_compile_keeps_default_device(small_decoder):
    """A prewarm compile started under jax.default_device targets that
    device, not the thread's default."""
    dec, _ = small_decoder
    d = jax.devices()[1]
    with jax.default_device(d):
        fut = beam._background(lambda: jax.numpy.ones(3).devices())
    assert fut.result() == {d}
