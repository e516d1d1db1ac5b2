"""chip_smoke.py --four rehearsed on four of the virtual CPU devices:
sharded decode equals the one-device decode, and sharded chain steps
equal the one-device steps."""

import jax

import chip_smoke
from test_chip_smoke import TINY


def test_four_device_phase_at_tiny_size(capsys):
    chip_smoke.phase_four(TINY, jax.devices()[:4])
    out = capsys.readouterr().out
    assert "phase=four " in out
    assert "sharded_decode_agree=8/8" in out and "graph_on_cards=4" in out
