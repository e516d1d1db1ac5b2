"""Raw component-stack networks — the nnet2 "raw Nnet" container.

Parity target: the upstream distinction between an *am-nnet*
(TransitionModel + priors + Nnet, src/nnet2/am-nnet.h) and a *raw
Nnet* (just the component stack, src/nnet2/nnet-nnet.h), with the
converter binaries nnet2bin/{nnet-to-raw-nnet, nnet1-to-raw-nnet,
raw-nnet-copy, raw-nnet-info, raw-nnet-concat}.cc.  Raw nets are used
upstream as feature-transform front-ends (e.g. the ivector-era
"append" networks) and for surgery between frameworks.

Redesign: a raw net is an ordered list of typed components,
each a (type, params) pair; `forward` folds the stack with jnp ops
(everything XLA-fusable; the stack is static so jit sees one graph).
Component types:

    splice      params: offsets (int vector)
    affine      params: kernel (in, out), bias (out,)
    sigmoid     —
    pnorm       params: out_dim, p (scalars)
    normalize   —
    logsoftmax  —
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from kaldi_tpu.core import io as kio
from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)

Component = Tuple[str, Dict[str, np.ndarray]]

_TYPES = ("splice", "affine", "sigmoid", "pnorm", "normalize",
          "logsoftmax")


def save_raw_nnet(path: str, components: List[Component]) -> None:
    from kaldi_tpu.am.serialize import write_pytree
    with kio.open_wxfilename(path) as f:
        kio.init_kaldi_output_stream(f)
        kio.write_token(f, "<RawNnet>")
        kio.write_basic_int32(f, len(components))
        for ctype, params in components:
            if ctype not in _TYPES:
                raise KaldiError(f"save_raw_nnet: unknown component "
                                 f"type {ctype}")
            kio.write_token(f, f"<{ctype}>")
            write_pytree(f, dict(params))
        kio.write_token(f, "</RawNnet>")


def load_raw_nnet(path: str) -> List[Component]:
    from kaldi_tpu.am.serialize import read_pytree
    with kio.open_rxfilename(path) as f:
        kio.init_kaldi_input_stream(f)
        kio.expect_token(f, "<RawNnet>")
        n = kio.read_basic_int32(f)
        comps: List[Component] = []
        for _ in range(n):
            tok = kio.read_token(f)
            ctype = tok[1:-1]
            if ctype not in _TYPES:
                raise KaldiError(f"load_raw_nnet: unknown component "
                                 f"type {ctype}")
            comps.append((ctype, read_pytree(f)))
        kio.expect_token(f, "</RawNnet>")
    return comps


def component_dims(comp: Component) -> Tuple[int, int]:
    """(input_dim, output_dim); -1 where shape-polymorphic."""
    ctype, params = comp
    if ctype == "affine":
        k = params["kernel"]
        return int(k.shape[0]), int(k.shape[1])
    if ctype == "splice":
        n = len(np.asarray(params["offsets"]).reshape(-1))
        return -1, -n          # output = n × input (marker)
    if ctype == "pnorm":
        return -1, int(np.asarray(params["out_dim"]).reshape(()))
    return -1, -1


def forward(components: List[Component], feats: np.ndarray):
    """Fold the stack over (T, D) or (B, T, D) features (jnp)."""
    import jax.numpy as jnp
    from kaldi_tpu.am.nnet2 import normalize_rms, pnorm
    from kaldi_tpu.am.tdnn import splice as splice_fn
    h = jnp.asarray(np.asarray(feats, np.float32))
    squeeze = h.ndim == 2
    if squeeze:
        h = h[None]
    for ctype, params in components:
        if ctype == "splice":
            offs = tuple(int(o) for o in
                         np.asarray(params["offsets"]).reshape(-1))
            h = splice_fn(h, offs)
        elif ctype == "affine":
            h = h @ jnp.asarray(params["kernel"]) \
                + jnp.asarray(params["bias"])
        elif ctype == "sigmoid":
            import jax.nn
            h = jax.nn.sigmoid(h)
        elif ctype == "pnorm":
            h = pnorm(h, int(np.asarray(params["out_dim"]).reshape(())),
                      float(np.asarray(params["p"]).reshape(())))
        elif ctype == "normalize":
            h = normalize_rms(h)
        elif ctype == "logsoftmax":
            import jax.nn
            h = jax.nn.log_softmax(h, axis=-1)
    return h[0] if squeeze else h


def from_nnet2(params: Dict, cfg) -> List[Component]:
    """Expand an Nnet2Model parameter tree into the component list
    (the nnet-to-raw-nnet conversion)."""
    comps: List[Component] = [
        ("splice", {"offsets": np.asarray(cfg.splice, np.int32)})]
    for i in range(cfg.num_hidden_layers):
        layer = params[f"pnorm{i + 1}"]["affine"]
        comps.append(("affine", {
            "kernel": np.asarray(layer["kernel"], np.float32),
            "bias": np.asarray(layer["bias"], np.float32)}))
        comps.append(("pnorm", {
            "out_dim": np.asarray(cfg.pnorm_output_dim, np.int32),
            "p": np.asarray(cfg.p, np.float32)}))
        comps.append(("normalize", {}))
    out = params["output_affine"]
    comps.append(("affine", {
        "kernel": np.asarray(out["kernel"], np.float32),
        "bias": np.asarray(out["bias"], np.float32)}))
    comps.append(("logsoftmax", {}))
    return comps


def from_nnet1(params: Dict, hid_dims, num_pdfs: int) -> List[Component]:
    """Expand an nnet1 sigmoid-DNN stack (the nnet1-to-raw-nnet
    conversion)."""
    comps: List[Component] = []
    for i in range(len(hid_dims)):
        layer = params[f"hidden{i + 1}"]
        comps.append(("affine", {
            "kernel": np.asarray(layer["kernel"], np.float32),
            "bias": np.asarray(layer["bias"], np.float32)}))
        comps.append(("sigmoid", {}))
    out = params["output_affine"]
    comps.append(("affine", {
        "kernel": np.asarray(out["kernel"], np.float32),
        "bias": np.asarray(out["bias"], np.float32)}))
    comps.append(("logsoftmax", {}))
    return comps
