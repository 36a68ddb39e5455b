"""LB-ADMM: latent binary factorization by ADMM (paper §3.2 Step 2-2,
App. B), the port of ``repro.core.admm``.

Minimizes ``½‖W̃ − U Vᵀ‖² + λ/2(‖U‖²+‖V‖²)  s.t.  U = Z_U, V = Z_V`` where
the proxies Z are SVID sign–value structures. The U/V updates are SPD
ridge systems solved by a stabilized Cholesky factorization; the proxy
update is SVID; duals are scaled. A linear penalty schedule ramps ρ over
the solve (paper App. C / Fig. 9b). The loop runs on the operands'
device without reading anything back to the host: the health guards are
tensor selects, as in the JAX package's scan.

Random draws come from a *key*: a tuple of ints naming the draw's place
in the pipeline (seed, block, [attempt,] linear), the path along which
the JAX package folds its PRNG keys. :func:`_rand_range_init` is the one
place that turns a key into numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.svid import svid


class QuantizationError(RuntimeError):
    """Structured per-block quantization failure.

    Raised by the pipeline's health guards instead of letting NaN/inf
    latents propagate into packing (where they would silently poison the
    artifact). Carries enough context for the fallback ladder to record
    the decision and for a human to find the bad block.
    """

    def __init__(self, layer: Optional[str], block: Optional[str],
                 iteration: Optional[int], reason: str):
        self.layer = layer
        self.block = block
        self.iteration = iteration
        self.reason = reason
        where = f"block={block!r}"
        if layer is not None:
            where += f" layer={layer!r}"
        if iteration is not None:
            where += f" iteration={iteration}"
        super().__init__(f"quantization failed at {where}: {reason}")


class ADMMConfig(NamedTuple):
    rank: int
    iters: int = 40
    rho_init: float = 1e-2
    rho_final: float = 1.0
    lam: float = 1e-4
    svid_iters: int = 8
    # health guards: a step whose updated factors go non-finite, or whose
    # relative residual exceeds divergence_factor for divergence_patience
    # consecutive iterations, is rejected — factors keep their last good
    # value, the scaled duals restart at zero, and the penalty gets a
    # bounded bump (x rho_growth, total scale capped at rho_scale_max).
    rho_growth: float = 2.0
    rho_scale_max: float = 16.0
    divergence_factor: float = 10.0
    divergence_patience: int = 5


Key = Tuple[int, ...]


def _generator(key: Key, device) -> torch.Generator:
    seed = int(np.random.SeedSequence([int(k) for k in key]).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _rand_range_init(key: Key, w, r: int):
    """Randomized rank-r range finder init. When r exceeds min(m, n) the
    overcomplete tail is filled with scaled gaussian columns (QR caps
    orthonormal columns at m). A stack of targets (E, m, n) draws expert
    e's numbers from ``key + (E, e)``, the place of JAX's
    ``jax.random.split(key, E)[e]``."""
    m, n = w.shape[-2:]
    lead = w.shape[:-2]
    gens = [_generator(key, w.device)] if not lead else \
        [_generator(tuple(key) + (lead[0], e), w.device)
         for e in range(lead[0])]

    def randn(*shape):
        return torch.stack([torch.randn(shape, generator=g, device=w.device)
                            for g in gens]).reshape(*lead, *shape)
    omega = randn(n, r)
    y = w @ omega                                   # (m, r)
    q, _ = torch.linalg.qr(y)                       # (m, min(m, r))
    b = w.mT @ q                                    # (n, min(m, r))
    if q.shape[-1] < r:
        extra = r - q.shape[-1]
        gq, gb = randn(m, extra), randn(n, extra)
        q = torch.cat([q, gq * (_fro_std(q) + 1e-6)], -1)
        b = torch.cat([b, gb * (_fro_std(b) + 1e-6)], -1)
    # balance magnitudes between factors
    nb = torch.clamp(_fro(b), min=1e-12)
    nq = torch.clamp(_fro(q), min=1e-12)
    s = torch.sqrt(nb / nq)
    return q * s, b / s


def _fro(t):
    """Frobenius norm of each matrix, kept as (..., 1, 1)."""
    return torch.linalg.vector_norm(t, dim=(-2, -1), keepdim=True)


def _fro_std(t):
    return t.std(dim=(-2, -1), correction=0, keepdim=True)


def _chol_solve_ridge(gram, rhs, shift):
    """Solve (gram + shift·I) X = rhs with stabilized Cholesky; a leading
    batch axis solves each system, `shift` then one per system, shaped
    (..., 1, 1). A matrix that is not positive definite gives NaN (as
    JAX's cholesky does), so the health guards see it; nothing is read
    back to the host."""
    r = gram.shape[-1]
    eye = torch.eye(r, dtype=gram.dtype, device=gram.device)
    c, info = torch.linalg.cholesky_ex(gram + (shift + 1e-8) * eye)
    c = torch.where((info == 0)[..., None, None], c,
                    torch.full_like(c, float("nan")))
    y = torch.linalg.solve_triangular(c, rhs, upper=False)
    return torch.linalg.solve_triangular(c.mT, y, upper=True)


def _all_finite(*ts):
    """Per matrix of a (possibly stacked) set: every entry finite."""
    out = torch.isfinite(ts[0]).flatten(-2).all(-1)
    for t in ts[1:]:
        out = out & torch.isfinite(t).flatten(-2).all(-1)
    return out


def lb_admm(w_target, cfg: ADMMConfig, key: Optional[Key] = None):
    """Run LB-ADMM on the preconditioned target (m, n), or on a stack of
    targets (E, m, n) at once, each solve independent of the others (the
    JAX package's ``vmap`` over experts): every scalar of the loop is then
    one per target.

    Returns a dict with the consensus proxies P_U = U+Λ_U, P_V = V+Λ_V
    (what magnitude balancing consumes), the raw factors, the
    per-iteration residual trace (iterations last) and the solve's
    ``health``."""
    w = w_target.float()
    dev = w.device
    lead = w.shape[:-2]
    r = cfg.rank
    u, v = _rand_range_init(key if key is not None else (0,), w, r)

    def full(value, dtype=torch.float32):
        return torch.full(lead, value, dtype=dtype, device=dev)

    def mat(t):                       # a per-target scalar over its matrix
        return t[..., None, None]

    def trace_mean(gram):             # the Gram's mean eigenvalue
        return gram.diagonal(dim1=-2, dim2=-1).sum(-1) / gram.shape[-1]

    zu, zv = svid(u, cfg.svid_iters), svid(v, cfg.svid_iters)
    lu = torch.zeros_like(u)
    lv = torch.zeros_like(v)
    rhos = torch.linspace(cfg.rho_init, cfg.rho_final, cfg.iters,
                          device=dev)
    rho_scale = full(1.0)
    best = full(float("inf"))
    bad = full(0, torch.int32)
    resets = full(0, torch.int32)
    w_norm = torch.clamp(torch.linalg.vector_norm(w, dim=(-2, -1)),
                         min=1e-12)
    trace = []
    for it in range(cfg.iters):
        # bounded rho adaptation: rejected steps (below) bump rho_scale
        rho_t = torch.clamp(rhos[it] * rho_scale,
                            max=cfg.rho_final * cfg.rho_scale_max)
        # U update: (VᵀV + (ρ+λ)I) Uᵀ = Vᵀ W̃ᵀ + ρ (Z_U − Λ_U)ᵀ   (Eq. 5),
        # ρ scale-free: a fraction of the data Gram's mean eigenvalue
        gram_v = v.mT @ v
        rho_u = mat(rho_t * trace_mean(gram_v))
        rhs_u = v.mT @ w.mT + rho_u * (zu - lu).mT
        u2 = _chol_solve_ridge(gram_v, rhs_u, rho_u + cfg.lam).mT
        # V update (symmetric)
        gram_u = u2.mT @ u2
        rho_v = mat(rho_t * trace_mean(gram_u))
        rhs_v = u2.mT @ w + rho_v * (zv - lv).mT
        v2 = _chol_solve_ridge(gram_u, rhs_v, rho_v + cfg.lam).mT
        # proxy updates (Eq. 6)
        zu2 = svid(u2 + lu, cfg.svid_iters)
        zv2 = svid(v2 + lv, cfg.svid_iters)
        # scaled dual updates
        lu2 = lu + u2 - zu2
        lv2 = lv + v2 - zv2
        res = torch.linalg.vector_norm(w - u2 @ v2.mT, dim=(-2, -1)) / w_norm
        # ---- health guards ------------------------------------------------
        finite = _all_finite(u2, v2, zu2, zv2) & torch.isfinite(res)
        bad = torch.where(finite & (res > cfg.divergence_factor), bad + 1,
                          torch.zeros_like(bad))
        reject = (~finite) | (bad >= cfg.divergence_patience)
        # rejected step: keep last good factors, restart the scaled duals
        # at zero, bump the penalty (bounded)
        rj = mat(reject)
        u, v = torch.where(rj, u, u2), torch.where(rj, v, v2)
        zu, zv = torch.where(rj, zu, zu2), torch.where(rj, zv, zv2)
        lu = torch.where(rj, torch.zeros_like(lu), lu2)
        lv = torch.where(rj, torch.zeros_like(lv), lv2)
        rho_scale = torch.where(
            reject, torch.clamp(rho_scale * cfg.rho_growth,
                                max=cfg.rho_scale_max), rho_scale)
        resets = resets + reject.to(torch.int32)
        bad = torch.where(reject, torch.zeros_like(bad), bad)
        best = torch.where(finite & ~reject, torch.minimum(best, res), best)
        trace.append(torch.where(finite, res,
                                 torch.full_like(res, float("inf"))))
    trace = torch.stack(trace, -1) if trace else \
        torch.zeros(lead + (0,), device=dev)
    nonfinite = ~_all_finite(u, v, zu, zv)
    final_res = trace[..., -1] if cfg.iters else full(float("inf"))
    return {
        "p_u": u + lu,          # consensus proxies (paper: P_U^{(K)})
        "p_v": v + lv,
        "u": u, "v": v, "z_u": zu, "z_v": zv,
        "residual_trace": trace,
        # resets counts rejected steps, rho_scale is the final bounded
        # penalty bump, diverged flags a solve whose final residual never
        # came back near its best
        "health": {
            "resets": resets,
            "rho_scale": rho_scale,
            "min_residual": best,
            "final_residual": final_res,
            "nonfinite": nonfinite,
            "diverged": (nonfinite | ~torch.isfinite(final_res)
                         | (final_res > cfg.divergence_factor)),
        },
    }
