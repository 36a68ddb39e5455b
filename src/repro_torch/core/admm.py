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
    orthonormal columns at m)."""
    m, n = w.shape
    gen = _generator(key, w.device)
    omega = torch.randn((n, r), generator=gen, device=w.device)
    y = w @ omega                                   # (m, r)
    q, _ = torch.linalg.qr(y)                       # (m, min(m, r))
    b = w.T @ q                                     # (n, min(m, r))
    if q.shape[1] < r:
        extra = r - q.shape[1]
        gq = torch.randn((m, extra), generator=gen, device=w.device)
        gb = torch.randn((n, extra), generator=gen, device=w.device)
        q = torch.cat([q, gq * (q.std(correction=0) + 1e-6)], 1)
        b = torch.cat([b, gb * (b.std(correction=0) + 1e-6)], 1)
    # balance magnitudes between factors
    nb = torch.clamp(torch.linalg.vector_norm(b), min=1e-12)
    nq = torch.clamp(torch.linalg.vector_norm(q), min=1e-12)
    s = torch.sqrt(nb / nq)
    return q * s, b / s


def _chol_solve_ridge(gram, rhs, shift):
    """Solve (gram + shift·I) X = rhs with stabilized Cholesky. A matrix
    that is not positive definite gives NaN (as JAX's cholesky does), so
    the health guards see it; nothing is read back to the host."""
    r = gram.shape[0]
    eye = torch.eye(r, dtype=gram.dtype, device=gram.device)
    c, info = torch.linalg.cholesky_ex(gram + (shift + 1e-8) * eye)
    c = torch.where(info == 0, c, torch.full_like(c, float("nan")))
    y = torch.linalg.solve_triangular(c, rhs, upper=False)
    return torch.linalg.solve_triangular(c.T, y, upper=True)


def _all_finite(*ts):
    out = torch.isfinite(ts[0]).all()
    for t in ts[1:]:
        out = out & torch.isfinite(t).all()
    return out


def lb_admm(w_target, cfg: ADMMConfig, key: Optional[Key] = None):
    """Run LB-ADMM on the preconditioned target (m, n).

    Returns a dict with the consensus proxies P_U = U+Λ_U, P_V = V+Λ_V
    (what magnitude balancing consumes), the raw factors, the
    per-iteration residual trace and the solve's ``health``."""
    w = w_target.float()
    dev = w.device
    r = cfg.rank
    u, v = _rand_range_init(key if key is not None else (0,), w, r)

    zu, zv = svid(u, cfg.svid_iters), svid(v, cfg.svid_iters)
    lu = torch.zeros_like(u)
    lv = torch.zeros_like(v)
    rhos = torch.linspace(cfg.rho_init, cfg.rho_final, cfg.iters,
                          device=dev)
    rho_scale = torch.tensor(1.0, device=dev)
    best = torch.tensor(float("inf"), device=dev)
    bad = torch.tensor(0, dtype=torch.int32, device=dev)
    resets = torch.tensor(0, dtype=torch.int32, device=dev)
    w_norm = torch.clamp(torch.linalg.vector_norm(w), min=1e-12)
    trace = []
    for it in range(cfg.iters):
        # bounded rho adaptation: rejected steps (below) bump rho_scale
        rho_t = torch.clamp(rhos[it] * rho_scale,
                            max=cfg.rho_final * cfg.rho_scale_max)
        # U update: (VᵀV + (ρ+λ)I) Uᵀ = Vᵀ W̃ᵀ + ρ (Z_U − Λ_U)ᵀ   (Eq. 5),
        # ρ scale-free: a fraction of the data Gram's mean eigenvalue
        gram_v = v.T @ v
        rho_u = rho_t * torch.trace(gram_v) / gram_v.shape[0]
        rhs_u = v.T @ w.T + rho_u * (zu - lu).T
        u2 = _chol_solve_ridge(gram_v, rhs_u, rho_u + cfg.lam).T
        # V update (symmetric)
        gram_u = u2.T @ u2
        rho_v = rho_t * torch.trace(gram_u) / gram_u.shape[0]
        rhs_v = u2.T @ w + rho_v * (zv - lv).T
        v2 = _chol_solve_ridge(gram_u, rhs_v, rho_v + cfg.lam).T
        # proxy updates (Eq. 6)
        zu2 = svid(u2 + lu, cfg.svid_iters)
        zv2 = svid(v2 + lv, cfg.svid_iters)
        # scaled dual updates
        lu2 = lu + u2 - zu2
        lv2 = lv + v2 - zv2
        res = torch.linalg.vector_norm(w - u2 @ v2.T) / w_norm
        # ---- health guards ------------------------------------------------
        finite = _all_finite(u2, v2, zu2, zv2, res)
        bad = torch.where(finite & (res > cfg.divergence_factor), bad + 1,
                          torch.zeros_like(bad))
        reject = (~finite) | (bad >= cfg.divergence_patience)
        # rejected step: keep last good factors, restart the scaled duals
        # at zero, bump the penalty (bounded)
        u, v = torch.where(reject, u, u2), torch.where(reject, v, v2)
        zu, zv = torch.where(reject, zu, zu2), torch.where(reject, zv, zv2)
        lu = torch.where(reject, torch.zeros_like(lu), lu2)
        lv = torch.where(reject, torch.zeros_like(lv), lv2)
        rho_scale = torch.where(
            reject, torch.clamp(rho_scale * cfg.rho_growth,
                                max=cfg.rho_scale_max), rho_scale)
        resets = resets + reject.to(torch.int32)
        bad = torch.where(reject, torch.zeros_like(bad), bad)
        best = torch.where(finite & ~reject, torch.minimum(best, res), best)
        trace.append(torch.where(finite, res,
                                 torch.full_like(res, float("inf"))))
    trace = torch.stack(trace) if trace else torch.zeros((0,), device=dev)
    nonfinite = ~_all_finite(u, v, zu, zv)
    final_res = trace[-1] if cfg.iters else torch.tensor(float("inf"),
                                                         device=dev)
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
