"""NanoQuant end-to-end pipeline (paper Alg. 1), the port of
``repro.core.pipeline`` for every family: dense, audio, MoE (GQA or MLA
attention, stacked experts), SSM (Mamba2), hybrid (Mamba2 with a shared
attention block) and VLM (self-attention blocks and gated cross-attention
blocks over image embeddings).

Phase 1  global calibration      -> diagonal K-FAC stats via the layers'
         taps (``models.layers.taps``)
Phase 2  block reconstruction    -> per block: TuneFP (error-propagation
         mitigation) -> LB-ADMM init + magnitude balancing -> STE latent
         refinement -> bit packing
Phase 3  model reconstruction    -> KL distillation of the packed model,
         tuning only the floating-point scales {s1, s2}; the packed
         linears' gradients come from ``kernels.ops.lowrank_binary_matmul``

Two activation streams are kept (paper §3.2 Step 1): X_q flows through
the already-compressed prefix, X_fp through the FP teacher; the block
target is always Y = B_fp(X_fp), so TuneFP absorbs accumulated
quantization error. The hybrid's shared block is quantized first, on
its inputs gathered from the teacher stream at every application; after
each Mamba2 block that it follows, X_q goes through the quantized shared
block and X_fp through the FP one. The VLM's cross blocks read a second
input, the calibration's image embeddings (``ctx["image_embeds"]``, the
batches' concatenated, sliced with each microbatch): their ``xattn.wk``
and ``xattn.wv`` are tapped over the image rows.

Random draws are named by key paths (``core.admm``): block bi's linear li
draws from ``(seed, bi, li)`` on the first rung of the init-method
ladder and ``(seed, bi, 7919 + ai, li)`` on rung ai — the path along
which the JAX package folds its PRNG keys; stacked experts are one
batched solve per linear at one rank, expert e drawing from the path
plus ``(E, e)`` (``core.admm._rand_range_init``). So a block's result
depends on nothing but its inputs, which is what makes a resumed run
bit-identical.

Crash safety: with a journal directory every finished block's packed
leaves and a crc32'd journal line are written as the run goes
(``checkpoint.journal.QuantJournal``, the JAX package's format); a resume
recomputes the calibration and the streams, reloads the finished blocks
and quantizes the rest. ``quant.faults.QuantFaultPlan`` injects crashes,
divergence and journal damage at the pipeline's seams.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import packing, precond, util
from repro_torch.core.admm import ADMMConfig, QuantizationError
from repro_torch.core.bpw import rank_for_bpw
from repro_torch.core.layout import quantizable_linear
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train.optim import AdamW, cosine_schedule


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    target_bpw: float = 1.0
    rank_align: int = 32
    # pack-time tile alignment of the packed d_in dim (32 = the packing
    # word: no extra padding — see core.packing.pack_quantized)
    pack_k_align: int = 32
    admm_iters: int = 40
    rho_init: float = 0.01
    rho_final: float = 1.0
    lam: float = 1e-4
    # preconditioner shrinkage (paper: 0.2 llama / qwen, 0.6 gemma)
    gamma: float = 0.2
    t_pre: int = 40               # TuneFP steps per block
    t_post: int = 60              # STE refinement steps per block
    t_glob: int = 60              # global KD steps
    lr_pre: float = 1e-4
    lr_post: float = 1e-5
    lr_glob: float = 1e-6
    microbatch: int = 4
    weighted_mse: bool = True
    min_dim: int = 48             # leave smaller linears in FP
    kd_temp: float = 1.0
    seed: int = 0
    # ablation switches (paper Tables 5-6)
    init_method: str = "lb_admm"  # lb_admm | dual_svid | dbf_admm
    skip_tune_fp: bool = False
    skip_ste: bool = False
    skip_kd: bool = False
    # init-method fallback ladder: a diverged block (non-finite latents /
    # losses / reconstruction error) is retried with these
    # ``register_init_method`` names, in order, after ``init_method``
    # (comma-separated, so the config stays hashable and JSON-manifest
    # round-trippable). "" disables fallbacks.
    fallback_inits: str = "dbf_admm,dual_svid"

    def admm(self) -> ADMMConfig:
        return ADMMConfig(rank=0, iters=self.admm_iters,
                          rho_init=self.rho_init, rho_final=self.rho_final,
                          lam=self.lam)


# ---------------------------------------------------------------------------
# block enumeration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockRef:
    stack: str                      # param-tree key
    idx: Any                        # index into the stack (int / tuple /
                                    # None)
    tap_idx: Any                    # layer index in tap stats (None=aggregate)
    kind: str                       # attn | mamba | cross

    def get(self, params):
        bp = params[self.stack]
        if self.idx is None:
            return bp
        for i in (self.idx if isinstance(self.idx, tuple) else (self.idx,)):
            bp = util.tree_index(bp, i)
        return bp


def blocks_of(cfg) -> List[BlockRef]:
    """The blocks in quantization order: the MoE family's
    ``first_k_dense`` blocks (``dense_layers``) before its MoE blocks; the
    hybrid's shared attention block (unstacked, its taps aggregated over
    its applications) before its Mamba2 layers; the VLM's groups in order,
    each its self blocks (``self_layers`` at (group, i), tapped under the
    flat index ``group · (cross_attn_every - 1) + i``) then its cross
    block (``cross_layers`` at the group)."""
    fam = cfg.family
    if fam in ("dense", "audio", "ssm"):
        kind = "mamba" if fam == "ssm" else "attn"
        return [BlockRef("layers", i, i, kind) for i in range(cfg.n_layers)]
    if fam == "moe":
        n_dense = cfg.first_k_dense
        return ([BlockRef("dense_layers", i, i, "attn")
                 for i in range(n_dense)]
                + [BlockRef("layers", i, i, "attn")
                   for i in range(cfg.n_layers - n_dense)])
    if fam == "hybrid":
        return ([BlockRef("shared_attn", None, None, "attn")]
                + [BlockRef("layers", i, i, "mamba")
                   for i in range(cfg.n_layers)])
    if fam == "vlm":
        per = cfg.cross_attn_every - 1
        out: List[BlockRef] = []
        for g in range(cfg.n_layers // cfg.cross_attn_every):
            out += [BlockRef("self_layers", (g, i), g * per + i, "attn")
                    for i in range(per)]
            out.append(BlockRef("cross_layers", g, g, "cross"))
        return out
    raise ValueError(fam)


def make_apply(cfg, kind):
    if kind == "attn":
        def f(bp, x, ctx):
            return T._apply_attn_block(
                bp, cfg, x, torch.arange(x.shape[1], device=x.device))
    elif kind == "mamba":
        def f(bp, x, ctx):
            return T._apply_mamba_block(bp, cfg, x)[0]
    elif kind == "cross":
        def f(bp, x, ctx):
            kv = L.image_kv(bp["xattn"], cfg, ctx["image_embeds"])
            return T._apply_cross_block(bp, cfg, x, kv)
    else:
        raise ValueError(kind)
    return f


# ---------------------------------------------------------------------------
# linear enumeration within a block
# ---------------------------------------------------------------------------


def linear_paths(bp, min_dim: int) -> List[Tuple[str, ...]]:
    paths = []

    def walk(d, path):
        for k in sorted(d.keys()):
            v = d[k]
            if isinstance(v, dict):
                if "w" in v and not isinstance(v["w"], dict):
                    if quantizable_linear(k, v["w"].shape, min_dim):
                        paths.append(path + (k,))
                else:
                    walk(v, path + (k,))

    walk(bp, ())
    return paths


def _get_path(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _set_path(tree, path, val):
    out = dict(tree)
    out[path[0]] = val if len(path) == 1 else \
        _set_path(tree[path[0]], path[1:], val)
    return out


# ---------------------------------------------------------------------------
# tuning loops
# ---------------------------------------------------------------------------


def _mse(out, tgt, weight=None):
    d = out.float() - tgt.float()
    if weight is not None:
        d = d * weight
    return d.square().mean()


def _channel_weight(Y, enabled):
    if not enabled:
        return None
    rms = torch.sqrt(Y.float().square().mean(dim=tuple(range(Y.dim() - 1)))
                     + 1e-8)
    w = 1.0 / rms
    return w / w.mean()


def _grads(loss, trainable):
    """d loss / d trainable as a tree of trainable's structure (zeros for
    leaves the loss does not reach)."""
    flat = util.leaves(trainable)
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(l)
              for g, l in zip(gs, flat))
    return util.tree_map(lambda _: next(it), trainable)


def _requires_grad(tree):
    return util.tree_map(lambda l: l.detach().requires_grad_(), tree)


def _tune(apply_fn, bp, pred, Xq, Y, ctx, steps, lr, mb, weighted, key):
    """Generic block tuning: optimize the leaves selected by `pred` so
    that apply_fn(bp, Xq) matches Y. Returns (bp, per-step losses)."""
    if steps <= 0:
        return bp, []
    trainable, frozen = util.partition(bp, pred)
    if not util.leaves(trainable):
        return bp, []
    weight = _channel_weight(Y, weighted)
    opt = AdamW(cosine_schedule(lr, steps), clip_norm=1.0)
    state = opt.init(trainable)
    n = Xq.shape[0]
    losses = []
    for s in range(steps):
        i0 = (s * mb) % max(n - mb + 1, 1)
        xb, yb = Xq[i0:i0 + mb], Y[i0:i0 + mb]
        cb = {k: v[i0:i0 + mb] for k, v in ctx.items()}
        tr = _requires_grad(trainable)
        with torch.enable_grad():
            lval = _mse(apply_fn(util.combine(tr, frozen), xb, cb), yb,
                        weight)
            grads = _grads(lval, tr)
        trainable, state, _ = opt.update(grads, state, trainable)
        losses.append(float(lval.detach()))
    return util.combine(trainable, frozen), losses


_LATENT_KEYS = ("lu", "lv", "s1", "s2")


def _is_latent_path(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in _LATENT_KEYS


def _is_scale_path(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in ("s1", "s2")


# ---------------------------------------------------------------------------
# init dispatch (Table 5 ablation), resolved through the init-method
# registry on every call so re-registered methods take effect
# ---------------------------------------------------------------------------


def _init_latent(p, d_in, d_out, qcfg: QuantConfig, key):
    """The init method's latents of one linear. Stacked experts (a 3-D
    ``w`` and (E, d) preconditioners) share one rank and go to the method
    as one stack, which the built-in methods solve batched over E."""
    from repro_torch.api.init_methods import get_init_method
    w = p["w"]
    din, dout = w.shape[-2:]
    r = rank_for_bpw(dout, din, qcfg.target_bpw, qcfg.rank_align)
    lat = dict(get_init_method(qcfg.init_method)(
        w, d_in, d_out, rank=r, admm=qcfg.admm(), key=key))
    if "b" in p:
        lat["b"] = p["b"]
    return lat, r


def _pack_latent(lat: dict, k_align: int = 32) -> dict:
    q = packing.pack_quantized(lat["lu"], lat["lv"], lat["s1"], lat["s2"],
                               k_align=k_align)
    if "b" in lat:
        q["b"] = lat["b"]
    return q


# ---------------------------------------------------------------------------
# health guards + per-block quantization with the init-method fallback
# ladder
# ---------------------------------------------------------------------------


def _ladder(qcfg: QuantConfig) -> List[str]:
    out = [qcfg.init_method]
    for m in qcfg.fallback_inits.split(","):
        m = m.strip()
        if m and m not in out:
            out.append(m)
    return out


def _check_finite(tree, block: str, layer, reason: str, iteration=None):
    """Raise a structured :class:`QuantizationError` if any float leaf of
    `tree` is non-finite — the guard that keeps NaNs out of packing and
    the saved artifact."""
    for where, leaf in util.leaves_with_path(tree):
        if leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf.float()).all()):
            raise QuantizationError(
                layer=layer if layer is not None else where, block=block,
                iteration=iteration,
                reason=f"{reason}: non-finite values in {where}")


def _attempt_key(kb, ai: int, li: int):
    """Key path of (attempt, linear) under block key `kb`; attempt 0 is
    the historical keying, so a run that never falls back keeps it."""
    return kb + (li,) if ai == 0 else kb + (7919 + ai, li)


def _quantize_block(apply_fn, bp_fp, Xq_b, Y, ctx_b, stats, bref,
                    label: str, qcfg: QuantConfig, kb, faults, bi: int,
                    log):
    """Steps 1-3 + packing for one block, with divergence detection and
    the init-method fallback ladder. Returns (packed bp, out_q, report
    row, {rank-key: rank})."""
    # Step 1: error-propagation mitigation (method-independent: run once,
    # shared across ladder attempts)
    if not qcfg.skip_tune_fp:
        bp_base, pre_losses = _tune(apply_fn, bp_fp, lambda p: True, Xq_b,
                                    Y, ctx_b, qcfg.t_pre, qcfg.lr_pre,
                                    qcfg.microbatch, qcfg.weighted_mse, kb)
    else:
        bp_base, pre_losses = bp_fp, []
    if pre_losses and not np.isfinite(pre_losses[-1]):
        raise QuantizationError(
            None, label, None, "TuneFP (error-propagation mitigation) "
            "diverged: non-finite loss — no init method can fix a "
            "poisoned block input; check calibration data")
    _check_finite(bp_base, label, None, "TuneFP output")

    lpaths = linear_paths(bp_base, qcfg.min_dim)
    ladder = _ladder(qcfg)
    fallbacks: List[dict] = []
    for ai, method in enumerate(ladder):
        try:
            # Step 2: low-rank binary initialization
            bp, ranks_b = bp_base, {}
            for li, path in enumerate(lpaths):
                pdict = _get_path(bp, path)
                name = ".".join(path)
                w = pdict["w"]
                d_in, d_out = precond.preconditioners_for(
                    stats, bref.stack, name, bref.tap_idx,
                    w.shape[-2], w.shape[-1], qcfg.gamma,
                    expert_shape=w.shape[0] if w.dim() == 3 else None,
                    device=w.device)
                lat, r = _init_latent(
                    pdict, d_in, d_out,
                    dataclasses.replace(qcfg, init_method=method),
                    _attempt_key(kb, ai, li))
                fault = (faults.poison_init(bi, li)
                         if faults is not None else None)
                if fault is not None:
                    lat = dict(lat, lu=torch.full_like(lat["lu"],
                                                       float("nan")))
                _check_finite(
                    {k: lat[k] for k in _LATENT_KEYS}, label, name,
                    f"init method {method!r} produced non-finite latents",
                    iteration=fault.iteration if fault is not None else None)
                ranks_b[f"{bref.stack}[{bref.idx}].{name}"] = r
                bp = _set_path(bp, path, lat)

            # Step 3: factorized component refinement (STE)
            if not qcfg.skip_ste:
                bp, ste_losses = _tune(apply_fn, bp, _is_latent_path,
                                       Xq_b, Y, ctx_b, qcfg.t_post,
                                       qcfg.lr_post, qcfg.microbatch,
                                       qcfg.weighted_mse, kb)
                if ste_losses and not np.isfinite(ste_losses[-1]):
                    raise QuantizationError(
                        None, label, None,
                        f"STE refinement diverged under init "
                        f"{method!r}: non-finite loss")
            else:
                ste_losses = []

            # pack + final guard
            for path in lpaths:
                bp = _set_path(bp, path,
                               _pack_latent(_get_path(bp, path),
                                            qcfg.pack_k_align))
            _check_finite(bp, label, None,
                          f"packed block under init {method!r}")
            out_q = apply_fn(bp, Xq_b, ctx_b)
            blk_err = float(_mse(out_q, Y))
            if not np.isfinite(blk_err):
                raise QuantizationError(
                    None, label, None, f"block reconstruction error is "
                    f"non-finite under init {method!r}")
            row = {"block": label,
                   "pre_loss": pre_losses[-1] if pre_losses else None,
                   "ste_loss": ste_losses[-1] if ste_losses else None,
                   "block_err": blk_err,
                   "init_method": method,
                   "fallbacks": list(fallbacks)}
            return bp, out_q, row, ranks_b
        except QuantizationError as e:
            fallbacks.append({"method": method, "layer": e.layer,
                              "iteration": e.iteration, "reason": e.reason})
            if ai == len(ladder) - 1:
                raise QuantizationError(
                    e.layer, label, e.iteration,
                    f"init-method fallback ladder exhausted "
                    f"({' -> '.join(ladder)}); last failure: {e.reason}")
            log(f"[nanoquant] {label}: init {method!r} diverged "
                f"({e.reason}) -> falling back to {ladder[ai + 1]!r}")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _clock(device) -> float:
    """Host seconds after the device has finished what was queued."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def nanoquant_quantize(params, cfg, calib_batches, qcfg: QuantConfig,
                       verbose: bool = True, journal_dir: str = None,
                       resume: bool = False, faults=None,
                       heartbeat: Optional[Callable[[str], None]] = None):
    """Quantize `params` (an FP teacher on its device) to packed low-rank
    binary form; every phase runs on the params' device.

    calib_batches: list of {'tokens', 'labels'} dicts (the audio
    family's (B, S, K) frames; the VLM's with 'image_embeds'). Returns
    (quantized params, report): per-block rows, the ranks, the KD losses,
    ``wall_s`` and ``seconds`` (calibration, the hybrid's gather of the
    shared block's inputs, each block, KD; each read after the device
    finished). `heartbeat` is called with a short progress string at
    block and KD boundaries (what ``launch.quantize --supervise`` watches).

    Crash safety: with `journal_dir`, every finished block's packed
    leaves and a crc32'd journal entry are written as the run goes
    (``checkpoint.journal.QuantJournal``); ``resume=True`` validates the
    journal against this run's fingerprint (model and quant configs,
    params, calibration), reloads the finished blocks and quantizes the
    rest: the artifact and the report rows are bit-identical to an
    uninterrupted run's. Calibration and the streams are recomputed; only
    blocks are skipped. A diverged block retries down the
    ``QuantConfig.fallback_inits`` ladder; every decision lands in the
    journal and the report. `faults` (a ``quant.faults.QuantFaultPlan``)
    injects a deterministic fault schedule."""
    if resume and not journal_dir:
        raise ValueError("resume=True requires journal_dir")
    blocks = blocks_of(cfg)
    dev = params["embed"].device
    t0 = _clock(dev)
    report: Dict[str, Any] = {"blocks": [], "ranks": {}}
    secs: Dict[str, Any] = {"blocks": []}

    def beat(msg: str) -> None:
        if heartbeat is not None:
            heartbeat(msg)

    def log(msg: str) -> None:
        if verbose:
            print(msg, flush=True)

    # ---- Phase 1: global calibration -------------------------------------
    stats = precond.collect_stats(T.loss_fn, params, cfg, calib_batches)
    t_cal = _clock(dev)
    secs["calibration"] = t_cal - t0

    # ---- journal / resume --------------------------------------------------
    journal, done = None, {}
    if journal_dir:
        from repro_torch.checkpoint.journal import (QuantJournal,
                                                    run_fingerprint)
        journal = QuantJournal(journal_dir)
        fingerprint = run_fingerprint(params, cfg, qcfg, calib_batches,
                                      len(blocks))
        if resume:
            done = journal.entries_for_resume(fingerprint)
            if done is None:                # no journal yet: a fresh start
                done = {}
                journal.start(fingerprint)
            elif done:
                log(f"[nanoquant] resuming: {len(done)}/{len(blocks)} "
                    f"blocks journaled in {journal_dir}")
        else:
            journal.start(fingerprint)
        secs["journal"] = time.perf_counter() - t_cal

    hybrid_boundary = (lambda i: T.shared_app(cfg, i) is not None)
    with torch.no_grad():
        # ---- activation streams ------------------------------------------
        toks = torch.cat([b["tokens"] for b in calib_batches], 0).to(dev)
        ctx: Dict[str, torch.Tensor] = {}
        if cfg.family == "vlm":
            ctx["image_embeds"] = torch.cat(
                [b["image_embeds"] for b in calib_batches], 0).to(dev)
        x0 = T.embed_tokens(params, cfg, toks)
        Xq, Xfp = x0, x0
        applies = {b.kind: make_apply(cfg, b.kind) for b in blocks}
        quantized: Dict[Tuple, Any] = {}

        # the hybrid's shared block is quantized first: its application
        # inputs are gathered from the teacher stream up front
        shared_inputs = None
        if cfg.family == "hybrid":
            t_g = _clock(dev)
            xs, gathered = x0, []
            for b in blocks:
                if b.stack != "layers":
                    continue
                xs = applies["mamba"](b.get(params), xs, ctx)
                if hybrid_boundary(b.idx):
                    gathered.append(xs)
                    xs = applies["attn"](params["shared_attn"], xs, ctx)
            shared_inputs = torch.cat(gathered, 0)
            del xs, gathered
            secs["gather"] = _clock(dev) - t_g

        # ---- Phase 2: block reconstruction -------------------------------
        for bi, bref in enumerate(blocks):
            t_b = time.perf_counter()
            label = f"{bref.stack}[{bref.idx}]"
            kb = (qcfg.seed, bi)
            bp_fp = bref.get(params)
            apply_fn = applies[bref.kind]
            if bref.stack == "shared_attn":
                Xq_b = Xfp_b = shared_inputs
            else:
                Xq_b, Xfp_b = Xq, Xfp
            Y = apply_fn(bp_fp, Xfp_b, ctx)
            if bi in done:
                # resumed: reload the packed block and replay its report
                # row; the recomputation it stands for is deterministic
                entry = done[bi]
                bp = util.tree_map(lambda t: t.to(dev),
                                   journal.load_block(bi))
                report["ranks"].update(entry["ranks"])
                row = dict(entry["row"])
                out_q = apply_fn(bp, Xq_b, ctx)
                beat(f"block={bi}/{len(blocks)} {label} resumed")
            else:
                if faults is not None:
                    faults.on_block_start(bi)
                beat(f"block={bi}/{len(blocks)} {label} start")
                bp, out_q, row, ranks_b = _quantize_block(
                    apply_fn, bp_fp, Xq_b, Y, ctx, stats, bref, label,
                    qcfg, kb, faults, bi, log)
                report["ranks"].update(ranks_b)
                if journal is not None:
                    extra = journal.save_block(bi, label, bp)
                    if faults is not None:
                        faults.after_block_save(bi)
                    journal.append_block({"bi": bi, "block": label,
                                          "ranks": ranks_b, "row": row,
                                          **extra})
                    if faults is not None:
                        faults.on_journal_append(bi, journal)
                beat(f"block={bi}/{len(blocks)} {label} done "
                     f"err={row['block_err']:.5f}")
            quantized[(bref.stack, bref.idx)] = bp

            # advance the streams
            if bref.stack != "shared_attn":
                Xq, Xfp = out_q, Y
                if hybrid_boundary(bref.idx):
                    Xq = applies["attn"](quantized[("shared_attn", None)],
                                         Xq, ctx)
                    Xfp = applies["attn"](params["shared_attn"], Xfp, ctx)
            report["blocks"].append(row)
            log(f"[nanoquant] {label} err={row['block_err']:.5f}"
                + (f" init={row['init_method']}" if row["fallbacks"] else ""))
            secs["blocks"].append(_clock(dev) - t_b)

        qparams = _assemble(params, cfg, quantized)

    # ---- Phase 3: scale-only model reconstruction (KD) --------------------
    t_kd = _clock(dev)
    if not qcfg.skip_kd and qcfg.t_glob > 0:
        qparams, kd_losses = _tune_scales_kd(params, qparams, cfg,
                                             calib_batches, qcfg,
                                             heartbeat=heartbeat)
        report["kd_losses"] = kd_losses
    t_end = _clock(dev)
    secs["kd"] = t_end - t_kd
    report["seconds"] = secs
    report["wall_s"] = t_end - t0
    return qparams, report


def _assemble(params, cfg, quantized):
    out = dict(params)
    stacks: Dict[str, dict] = {}
    for (stack, idx), bp in quantized.items():
        stacks.setdefault(stack, {})[idx] = bp
    for stack, items in stacks.items():
        if None in items:                       # unstacked (shared_attn)
            out[stack] = items[None]
        elif isinstance(next(iter(items)), tuple):   # (g, i): vlm self
            gs = sorted({g for g, _ in items})
            per = sorted({i for _, i in items})
            out[stack] = util.tree_stack(
                [util.tree_stack([items[(g, i)] for i in per]) for g in gs])
        else:
            out[stack] = util.tree_stack([items[i] for i in sorted(items)])
    return out


def _kd_loss_chunked(hS, hT, params_s, params_t, cfg, temp):
    """Mean over tokens of KL(teacher || student) of the head's logits at
    temperature `temp`, by sequence chunks of ``cfg.loss_chunk``."""
    wS = T._head_w(params_s, cfg)
    wT = T._head_w(params_t, cfg)
    S = hS.shape[1]
    chunk = min(cfg.loss_chunk or S, S)
    if S % chunk:
        chunk = S
    tot = 0.0
    for c in range(0, S, chunk):
        hs, ht = hS[:, c:c + chunk], hT[:, c:c + chunk]
        zS = (hs @ wS.to(hs.dtype)).float() / temp
        zT = (ht @ wT.to(ht.dtype)).float() / temp
        kl = (torch.softmax(zT, -1) * (torch.log_softmax(zT, -1)
                                       - torch.log_softmax(zS, -1))).sum(-1)
        tot = tot + kl.sum()
    return tot / (hS.shape[0] * S)


def _tune_scales_kd(teacher, qparams, cfg, calib_batches, qcfg: QuantConfig,
                    heartbeat=None):
    """Phase 3 (Eq. 11): packed binaries frozen, optimize only {s1, s2}.
    Returns (qparams, per-step KD losses)."""
    trainable, frozen = util.partition(qparams, _is_scale_path)
    opt = AdamW(cosine_schedule(qcfg.lr_glob, qcfg.t_glob), clip_norm=1.0)
    state = opt.init(trainable)
    dev = teacher["embed"].device
    losses = []
    for s in range(qcfg.t_glob):
        batch = calib_batches[s % len(calib_batches)]
        toks = batch["tokens"].to(dev)
        img = batch.get("image_embeds")
        img = None if img is None else img.to(dev)
        with torch.no_grad():
            hT = T.backbone(teacher, cfg, toks, img)
        tr = _requires_grad(trainable)
        with torch.enable_grad():
            qp = util.combine(tr, frozen)
            hS = T.backbone(qp, cfg, toks, img)
            lval = _kd_loss_chunked(hS, hT, qp, teacher, cfg, qcfg.kd_temp)
            grads = _grads(lval, tr)
        trainable, state, _ = opt.update(grads, state, trainable)
        losses.append(float(lval.detach()))
        if heartbeat is not None and (s % 10 == 0 or s == qcfg.t_glob - 1):
            heartbeat(f"kd step={s + 1}/{qcfg.t_glob} loss={losses[-1]:.5f}")
    return util.combine(trainable, frozen), losses


# public name: run Phase 3 standalone with its own data budget (paper
# Table 9 block-vs-model reconstruction splits)
tune_scales_kd = _tune_scales_kd
