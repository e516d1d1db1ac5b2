"""Device-side per-op profiling — the `CuDevice::PrintProfile` role.

Parity target: src/cudamatrix/cu-device.h `CuDevice::PrintProfile`
(per-kernel-tag accumulated time printed at exit when profiling is on)
and the RTF prints of src/decoder/decoder-wrappers.cc.

Design: wrap a region in `profile(...)` — it captures a
`jax.profiler` trace, then parses the trace's xplane protobuf DIRECTLY
(raw wire format, no generated proto bindings or tensorboard deps)
and aggregates device op durations per op.  `print_profile` renders
the top ops the way CuDevice prints kernel tags.

Trace layout: device planes are named ``/device:<KIND>:<n>``.  On a
GPU each CUDA stream is one line of the device plane, named
``Stream #<id>(<kinds>)`` (e.g. ``Stream #13(Compute)``), and its
events are the kernels XLA launched: fusion names (``loop_add_fusion``,
``sort_6_1``), library kernels (cuBLAS ``sm90_xmma_gemm_*``) and copies
(``memcpy128``).  A backend whose device plane has a line named
``XLA Ops`` carries the per-op events there, beside summary lines; only
that line is read for such a plane.  Host planes (``/host:CPU``) hold
Python and runtime threads and are not device time.

xplane wire schema (tensorflow/profiler protos, stable since 2020):
  XSpace{planes=1} / XPlane{id=1,name=2,lines=3,event_metadata=4(map)}
  XLine{name=2(display 11),events=4}
  XEvent{metadata_id=1,offset_ps=2,duration_ps=3}
  map entry {key=1, value=XEventMetadata{id=1,name=2}}
"""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from kaldi_tpu.core.logging import get_logger

log = get_logger(__name__)

DEVICE_PLANE_PREFIX = "/device:"
OPS_LINE = "XLA Ops"


# ---------------------------------------------------------------------------
# protobuf wire-format primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, i
        shift += 7


def _fields(buf: bytes):
    """Yield (field_no, wire_type, value) over one message buffer."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fno, wt, v


def _parse_plane(buf: bytes):
    name = ""
    lines = []
    meta: Dict[int, str] = {}
    for fno, wt, v in _fields(buf):
        if fno == 2 and wt == 2:
            name = v.decode("utf-8", "replace")
        elif fno == 3 and wt == 2:
            lines.append(v)
        elif fno == 4 and wt == 2:
            k = None
            mname = ""
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 0:
                    k = v2
                elif f2 == 2 and w2 == 2:
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 2 and w3 == 2:
                            mname = v3.decode("utf-8", "replace")
            if k is not None:
                meta[k] = mname
    return name, lines, meta


def _parse_line(buf: bytes):
    name = ""
    events = []
    for fno, wt, v in _fields(buf):
        if fno in (2, 11) and wt == 2:
            name = v.decode("utf-8", "replace") or name
        elif fno == 4 and wt == 2:
            events.append(v)
    return name, events


def _parse_event(buf: bytes) -> Tuple[int, int]:
    mid = dur = 0
    for fno, wt, v in _fields(buf):
        if fno == 1 and wt == 0:
            mid = v
        elif fno == 3 and wt == 0:
            dur = v
    return mid, dur


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

class OpProfile:
    """Aggregated per-op device time from one captured trace."""

    def __init__(self):
        # plane name -> line name -> op name -> [total_ps, count]
        self.planes: Dict[str, Dict[str, Dict[str, List[int]]]] = {}

    def _lines(self, line_filter: Optional[str]):
        """(plane, line, ops) selected by line_filter: None = the device
        op lines (see the module docstring), "" = every parsed line, any
        other string = the lines whose name contains it."""
        for pname, lines in self.planes.items():
            if line_filter is None:
                if not pname.startswith(DEVICE_PLANE_PREFIX):
                    continue
                named = [l for l in lines if OPS_LINE in l]
                for lname in (named or lines):
                    yield pname, lname, lines[lname]
                continue
            for lname, ops in lines.items():
                if line_filter and line_filter not in lname:
                    continue
                yield pname, lname, ops

    def ops(self, line_filter: Optional[str] = None
            ) -> List[Tuple[str, float, int]]:
        """(op name, total ms, count) over the lines line_filter
        selects (default: device op lines), sorted by descending total
        time."""
        agg: Dict[str, List[int]] = defaultdict(lambda: [0, 0])
        for _pname, _lname, ops in self._lines(line_filter):
            for op, (ps, cnt) in ops.items():
                agg[op][0] += ps
                agg[op][1] += cnt
        out = [(op, ps / 1e9, cnt) for op, (ps, cnt) in agg.items()]
        out.sort(key=lambda t: -t[1])
        return out

    def total_ms(self, line_filter: Optional[str] = None) -> float:
        return sum(ms for _, ms, _ in self.ops(line_filter))


def parse_xplane(path: str, device_only: bool = True) -> OpProfile:
    """Parse one .xplane.pb file into an OpProfile."""
    with open(path, "rb") as f:
        buf = f.read()
    prof = OpProfile()
    for fno, wt, v in _fields(buf):
        if fno != 1 or wt != 2:
            continue
        pname, lines, meta = _parse_plane(v)
        if device_only and not pname.startswith(DEVICE_PLANE_PREFIX):
            continue
        plines = prof.planes.setdefault(pname, {})
        for lb in lines:
            lname, events = _parse_line(lb)
            ops = plines.setdefault(lname, {})
            for eb in events:
                mid, dur = _parse_event(eb)
                a = ops.setdefault(meta.get(mid, f"#{mid}"), [0, 0])
                a[0] += dur
                a[1] += 1
    return prof


@contextlib.contextmanager
def profile(trace_dir: str = None):
    """Capture a jax.profiler trace around the with-body and yield a
    callable returning the parsed OpProfile::

        with profile() as prof:
            run_steps()
        print_profile(prof())
    """
    import jax

    own = trace_dir is None
    if own:
        trace_dir = tempfile.mkdtemp(prefix="kaldi_tpu_trace_")
    result = {}

    def get() -> OpProfile:
        if "prof" not in result:
            merged = OpProfile()
            for p in sorted(glob.glob(
                    os.path.join(trace_dir, "**", "*.xplane.pb"),
                    recursive=True)):
                # keep every plane; ops()/print_profile select the
                # device op lines, and line_filter="" still reads
                # host-only (CPU backend) traces
                sub = parse_xplane(p, device_only=False)
                merged.planes.update(sub.planes)
            result["prof"] = merged
        return result["prof"]

    with jax.profiler.trace(trace_dir):
        yield get


def print_profile(prof: OpProfile, top: int = 20, min_frac: float = 0.002,
                  line_filter: Optional[str] = None) -> None:
    """Render the per-op table (CuDevice::PrintProfile format)."""
    ops = prof.ops(line_filter)
    tot = sum(ms for _, ms, _ in ops)
    log.info("device op profile: %.3f ms total over %d ops",
             tot, len(ops))
    for op, ms, cnt in ops[:top]:
        if ms < tot * min_frac:
            break
        log.info("  %9.3f ms  x%-5d %s", ms, cnt, op[:110])
