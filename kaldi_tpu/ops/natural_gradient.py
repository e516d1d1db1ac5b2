"""Online natural-gradient (NG-SGD) preconditioning.

Parity target: the reference's OnlineNaturalGradient
(src/nnet3/natural-gradient-online.h, "Parallel training of DNNs with
natural gradient and parameter averaging", Povey et al. 2014).  The
reference maintains, per affine component and per side (input features
/ output derivatives), a low-rank-plus-identity online estimate of the
Fisher/covariance matrix F ≈ U diag(d) Uᵀ + ρ(I − U Uᵀ), and
preconditions update directions X by a smoothed inverse of F with a
rescaling γ that preserves the update magnitude.

Redesign: instead of the reference's in-place iterative
update, the estimate is advanced by one step of SUBSPACE (power)
ITERATION followed by Rayleigh–Ritz extraction — all fixed-shape
matmuls + one tiny (R×R) eigendecomposition, so the whole transform
jits and runs on the matrix units.  Mathematically both track the top-R
eigenspace of the exponential-moving-average covariance; the trace is
preserved exactly so ρ absorbs the mass outside the subspace, as in
the reference.

Two entry points:
  * ng_init / ng_precondition — the OnlineNaturalGradient object as a
    pure function over NGState: X (N×D samples) → (X̄ preconditioned,
    γ scale, new state).
  * scale_ng() — an optax gradient transform applying two-sided NG to
    every 2-D parameter's gradient G: rows of G are treated as samples
    for the input-side Fisher and columns for the output-side, the
    factored analogue of the reference preconditioning the affine
    update on both sides.  1-D parameters pass through (the reference
    also preconditions bias via the appended-1 trick; here biases are
    left to the outer optimizer).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax


class NGState(NamedTuple):
    U: jax.Array      # (D, R) orthonormal basis of the tracked subspace
    d: jax.Array      # (R,) eigenvalue estimates inside the subspace
    rho: jax.Array    # () eigenvalue estimate outside the subspace
    t: jax.Array      # () update count


def ng_init(dim: int, rank: int = 20, dtype=jnp.float32) -> NGState:
    """Fresh estimator.  rank is clamped to dim-1 like the reference's
    --rank-in/--rank-out defaults (20/80) being cut for small layers."""
    rank = max(1, min(rank, dim - 1)) if dim > 1 else 1
    U = jnp.eye(dim, rank, dtype=dtype)
    return NGState(U=U, d=jnp.zeros(rank, dtype),
                   rho=jnp.asarray(1e-10, dtype),
                   t=jnp.zeros((), jnp.int32))


def ng_apply(state: NGState, X: jax.Array, alpha: float = 4.0,
             eps: float = 1e-10) -> jax.Array:
    """Apply the smoothed inverse Fisher to rows of X (N×D):
    X̄ = X · (F + α·(tr F / D)·I)⁻¹ with
    F = U diag(d) Uᵀ + ρ(I − U Uᵀ).  Pure linear map, no rescale —
    callers compose a γ over whatever product of applications they use
    (see ng_precondition / scale_ng)."""
    D = X.shape[1]
    U, d, rho, _ = state
    R = U.shape[1]
    Xf = X.astype(jnp.float32)
    tr = jnp.sum(d) + rho * (D - R)
    s = alpha * jnp.maximum(tr / D, eps)
    P = Xf @ U                                     # (N, R)
    inv_in = 1.0 / (d + s)   # inside the subspace; outside: 1/(ρ + s)
    return ((Xf - P @ U.T) / (rho + s) + (P * inv_in) @ U.T).astype(X.dtype)


def ng_advance(state: NGState, X: jax.Array,
               num_samples_history: float = 2000.0,
               eps: float = 1e-10) -> NGState:
    """Advance the EMA covariance estimate with samples = rows of X.

    One step of subspace (power) iteration on
    F' = (1−η) F + η Ĉ  (Ĉ = XᵀX/N), followed by Rayleigh–Ritz
    extraction; the trace is preserved exactly, with mass outside the
    tracked subspace absorbed into ρ (reference semantics)."""
    N, D = X.shape
    U, d, rho, t = state
    R = U.shape[1]
    Xf = X.astype(jnp.float32)
    tr = jnp.sum(d) + rho * (D - R)
    # forgetting factor from the sample-count history, as in the
    # reference's num_samples_history; first call adopts Ĉ outright
    eta = 1.0 - jnp.exp(-N / num_samples_history)
    eta = jnp.where(t == 0, 1.0, eta)
    XU = Xf @ U                                     # (N, R)
    CU = Xf.T @ XU / N                              # (D, R) = Ĉ U
    # F U = U diag(d)  ⇒  F' U = (1−η) U diag(d) + η Ĉ U
    Z = (1.0 - eta) * U * d[None, :] + eta * CU
    # guard against rank collapse before orthonormalization
    Z = Z + eps * U
    Q, _ = jnp.linalg.qr(Z)                         # (D, R) orthonormal
    # Rayleigh–Ritz: M = Qᵀ F' Q from the low-rank pieces
    A = U.T @ Q                                     # (R, R)
    XQ = Xf @ Q                                     # (N, R)
    M = ((1.0 - eta) * (A.T * d[None, :]) @ A
         + (1.0 - eta) * rho * (jnp.eye(R) - A.T @ A)
         + eta * XQ.T @ XQ / N)
    M = 0.5 * (M + M.T)
    w, V = jnp.linalg.eigh(M)                       # ascending
    order = jnp.argsort(-w)
    w = w[order]
    V = V[:, order]
    new_U = Q @ V
    # exact trace preservation: mass outside the subspace goes to ρ
    new_tr = (1.0 - eta) * tr + eta * jnp.sum(Xf * Xf) / N
    new_d = jnp.maximum(w, eps)
    new_rho = jnp.maximum((new_tr - jnp.sum(new_d)) / jnp.maximum(D - R, 1),
                          eps)
    return NGState(U=new_U, d=new_d, rho=new_rho, t=t + 1)


def ng_precondition(state: NGState, X: jax.Array, alpha: float = 4.0,
                    num_samples_history: float = 2000.0,
                    eps: float = 1e-10):
    """Precondition rows of X (N×D) by the smoothed inverse Fisher and
    advance the estimate.  Returns (X̄, γ, new_state) with
    γ·‖X̄‖_F = ‖X‖_F (scale preservation, reference semantics: the
    effective learning rate is untouched, only the direction changes).
    """
    Xf = X.astype(jnp.float32)
    Xbar = ng_apply(state, Xf, alpha, eps)
    num = jnp.sum(Xf * Xf)
    den = jnp.sum(Xbar * Xbar)
    # the floor must sit far below any legitimately tiny ‖X̄‖² (the
    # inverse of large Fisher eigenvalues squared can reach ~1e-18),
    # else gamma is silently capped and the update collapses
    gamma = jnp.sqrt(jnp.maximum(num, 1e-30) / jnp.maximum(den, 1e-30))
    # first call: estimate is vacuous (d=0) — pass X through unchanged
    first = state.t == 0
    Xbar = jnp.where(first, Xf, Xbar)
    gamma = jnp.where(first, 1.0, gamma)
    new_state = ng_advance(state, Xf, num_samples_history, eps)
    return Xbar.astype(X.dtype), gamma.astype(X.dtype), new_state


class _ScaleNGState(NamedTuple):
    states: dict
    step: jax.Array


def scale_ng(rank_in: int = 20, rank_out: int = 20, alpha: float = 4.0,
             num_samples_history: float = 2000.0,
             update_period: int = 4
             ) -> optax.GradientTransformation:
    """Two-sided natural-gradient preconditioning of 2-D gradients.

    For G of shape (out, in): the input-side Fisher sees G's rows as
    samples of dim `in`, the output-side sees Gᵀ's rows as samples of
    dim `out` — BOTH estimated from the raw gradient, mirroring the
    reference where each OnlineNaturalGradient instance sees raw
    activations / raw output derivatives.  The two smoothed inverses
    are then applied as linear maps, Ḡ ∝ M_out · G · M_in, and ONE
    γ rescales the product so ‖Ḡ‖_F = ‖G‖_F.  (Estimating the
    out-side from the already-preconditioned G would mis-scale its
    eigenvalues by the in-side's inverse — the estimate must track raw
    statistics.)  Non-2-D leaves pass through.  Compose before the
    learning-rate/optimizer step, e.g.
    optax.chain(scale_ng(), optax.sgd(lr)).

    ``update_period``: the Fisher estimates ADVANCE only every k-th
    step (the reference's OnlineNaturalGradient update_period, nnet3
    default 4) — preconditioning still applies every step.  The
    advance (QR + Rayleigh–Ritz per leaf side, ~60 small launches per
    step for a 13-layer TDNN-F) is the expensive part, so this
    amortizes it with the reference's own semantics.
    """

    def init(params):
        def leaf(p):
            if p.ndim != 2:
                return None
            o, i = p.shape
            return (ng_init(i, rank_in), ng_init(o, rank_out))
        return _ScaleNGState(states=jax.tree.map(leaf, params),
                             step=jnp.zeros((), jnp.int32))

    def update(updates, state, params=None):
        del params
        # the reference updates UNCONDITIONALLY for the first ~10
        # steps (OnlineNaturalGradient::Updating) so the estimate is
        # refined past the single-sample adoption before the period
        # kicks in
        do_adv = ((state.step < 10)
                  | ((state.step % update_period) == 0))

        def leaf(g, st):
            if st is None or g.ndim != 2:
                return g, st
            st_in, st_out = st
            gf = g.astype(jnp.float32)
            gbar = ng_apply(st_out, ng_apply(st_in, gf, alpha).T, alpha).T
            num = jnp.sum(gf * gf)
            den = jnp.sum(gbar * gbar)
            # floor well below f32-representable ‖Ḡ‖² — see
            # ng_precondition; two inverse applications can leave
            # den ~1e-18 legitimately
            gamma = jnp.sqrt(jnp.maximum(num, 1e-30)
                             / jnp.maximum(den, 1e-30))
            first = st_in.t == 0
            gbar = jnp.where(first, gf, gbar)
            gamma = jnp.where(first, 1.0, gamma)
            st_in, st_out = jax.lax.cond(
                do_adv,
                lambda s: (ng_advance(s[0], gf, num_samples_history),
                           ng_advance(s[1], gf.T,
                                      num_samples_history)),
                lambda s: s, (st_in, st_out))
            return (gamma * gbar).astype(g.dtype), (st_in, st_out)

        flat_u, tdef = jax.tree.flatten(updates)
        flat_s = tdef.flatten_up_to(state.states)
        out = [leaf(g, s) for g, s in zip(flat_u, flat_s)]
        new_u = tdef.unflatten([o[0] for o in out])
        new_s = tdef.unflatten([o[1] for o in out])
        return new_u, _ScaleNGState(states=new_s, step=state.step + 1)

    return optax.GradientTransformation(init, update)


def ngsgd(learning_rate, momentum: Optional[float] = None,
          rank_in: int = 20, rank_out: int = 20, alpha: float = 4.0,
          update_period: int = 4) -> optax.GradientTransformation:
    """NG-SGD: the reference's training update = natural-gradient
    preconditioning + plain (momentum) SGD.  alpha is the smoothing
    toward identity (reference default 4.0; smaller = closer to the
    exact inverse Fisher, stronger equalization); update_period=1
    restores the advance-every-step (pre-r4) dynamics."""
    parts = [scale_ng(rank_in=rank_in, rank_out=rank_out, alpha=alpha,
                      update_period=update_period)]
    if momentum:
        parts.append(optax.trace(decay=momentum))
    parts.append(optax.scale_by_learning_rate(learning_rate))
    return optax.chain(*parts)
