"""core/profiling: capture a trace, parse xplane, attribute op time.

Oracle: a jitted dot-heavy region must yield a nonempty per-op profile
whose total device time is positive and whose top op names are real
XLA ops (reference role: cu-device.h CuDevice::PrintProfile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kaldi_tpu.core.profiling import (OpProfile, parse_xplane, profile,
                                      print_profile)


def test_profile_captures_ops(tmp_path):
    x = jnp.asarray(np.random.default_rng(0)
                    .standard_normal((256, 256)).astype(np.float32))

    @jax.jit
    def f(a):
        return jnp.tanh(a @ a).sum()

    jax.block_until_ready(f(x))     # compile outside the trace
    with profile(str(tmp_path)) as get:
        for _ in range(3):
            out = f(x)
        jax.block_until_ready(out)
    prof = get()
    assert prof.planes, "no device/host planes parsed"
    ops = prof.ops(line_filter="")
    assert ops, "no ops aggregated"
    assert prof.total_ms(line_filter="") > 0
    # every aggregate is (name, ms>=0, count>=1)
    for name, ms, cnt in ops:
        assert isinstance(name, str) and cnt >= 1 and ms >= 0
    print_profile(prof, line_filter="")     # must not raise


def test_parse_rejects_garbage(tmp_path):
    p = tmp_path / "bad.xplane.pb"
    p.write_bytes(b"\x07not a proto")     # wire type 7: invalid
    with pytest.raises(Exception):
        parse_xplane(str(p))
    # benign-looking garbage parses to an empty profile, never junk
    p2 = tmp_path / "empty.xplane.pb"
    p2.write_bytes(b"")
    assert parse_xplane(str(p2)).total_ms(line_filter="") == 0.0


def test_empty_profile_total():
    assert OpProfile().total_ms() == 0.0


def test_default_reads_gpu_stream_lines():
    """A GPU trace has no 'XLA Ops' line: its device plane holds one
    line per CUDA stream, and those are the device op lines.  Host
    planes never count as device time."""
    prof = OpProfile()
    prof.planes = {
        "/device:GPU:0": {
            "Stream #13(Compute)": {"loop_add_fusion": [3_000_000_000, 3],
                                    "sort_6_1": [1_000_000_000, 1]},
            "Stream #14(MemcpyD2H)": {"memcpy128": [500_000_000, 2]},
        },
        "/host:CPU": {"python": {"PjitFunction(f)": [9_000_000_000, 6]}},
    }
    ops = prof.ops()
    assert [o[0] for o in ops] == ["loop_add_fusion", "sort_6_1",
                                   "memcpy128"]
    assert ops[0][1] == 3.0 and ops[0][2] == 3
    assert prof.total_ms() == 4.5
    # "" still reads every parsed line, host included
    assert prof.total_ms(line_filter="") == 13.5


def test_default_prefers_xla_ops_line():
    """Where a device plane carries an 'XLA Ops' line beside summary
    lines, only that line is read."""
    prof = OpProfile()
    prof.planes = {"/device:X:0": {
        "XLA Modules": {"jit_step": [5_000_000_000, 1]},
        "XLA Ops": {"fusion.1": [2_000_000_000, 4]},
    }}
    assert prof.ops() == [("fusion.1", 2.0, 4)]
