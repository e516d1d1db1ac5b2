"""chip_smoke.py: the gate refuses a machine without a GPU, and every
one-card phase runs end to end on the CPU backend at a tiny size (the
rehearsal of the card run: same entry points, same checks)."""

import jax
import pytest

import chip_smoke

TINY = chip_smoke.Sizes(
    vocab=400, n_utts=8, batch=4, n_cpu=2, n_stream=2, n_lanes=2,
    lane_chunks=30, stream_max_frames=256, lane_max_frames=256,
    hidden=32, bottleneck=8, layers=4, egs=8, egs_frames=30, steps=2,
    n_fwd=2, n_served=2, n_four=8)


def test_gate_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


def test_main_exits_nonzero_without_printing(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_one_card_phases_at_tiny_size(capsys):
    jax.monitoring.register_event_duration_secs_listener(
        chip_smoke._count_compile)
    chip_smoke.run_single(TINY, jax.devices("cpu")[0])
    out = capsys.readouterr().out
    for phase in ("decode", "stream", "train", "served"):
        assert f"phase={phase} " in out
    assert "beta_on_wer=0.00" in out and "cpu_agree=2/2" in out
    assert "lanes_agree=2/2" in out
