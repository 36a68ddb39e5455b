"""Pre-quantization validation, the port of ``repro.quant.preflight``.

A quantization run of hours should fail in its first second with a
message naming the bad input, not at block 17 with a NaN loss or an
out-of-memory kill. ``preflight(params, cfg, calib_batches)`` checks, in
order:

1. calibration batches — present, integer ``tokens`` of shape (batch,
   seq) (the audio family's (batch, seq, n_codebooks) frames) with one
   sequence length, every id inside ``[0, vocab_size)``, ``labels`` (when
   present) shaped like the tokens, and for the VLM ``image_embeds`` in
   every batch, finite;
2. teacher params — every float leaf finite; a failure names the leaf
   path (a NaN teacher poisons every block downstream);
3. a per-block working-set estimate (activation streams, the VLM's
   image embeddings, the largest block's params, LB-ADMM's factor state)
   against the free memory of the device the params live on: on a CUDA
   card ``torch.cuda.mem_get_info`` (the pipeline's working set lives
   there), on the CPU the host's ``MemAvailable``, as the reference
   reads.

Every failure raises :class:`PreflightError`.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List

import torch

from repro_torch.core import util


class PreflightError(ValueError):
    """A quantization input failed validation before any work ran."""


def _check_calib(cfg, calib_batches) -> int:
    if not calib_batches:
        raise PreflightError("no calibration batches given — the pipeline "
                             "needs at least one {'tokens', ...} batch")
    ndim = 3 if cfg.family == "audio" else 2
    shape = ("(batch, seq, n_codebooks)" if ndim == 3 else "(batch, seq)")
    seqs = set()
    n_tokens = 0
    for i, b in enumerate(calib_batches):
        if "tokens" not in b:
            raise PreflightError(f"calibration batch {i} has no 'tokens'")
        toks = torch.as_tensor(b["tokens"])
        if toks.dim() != ndim or (ndim == 3
                                  and toks.shape[-1] != cfg.n_codebooks):
            raise PreflightError(
                f"calibration batch {i}: tokens must be {shape}, got shape "
                f"{tuple(toks.shape)}")
        if toks.is_floating_point() or toks.is_complex() \
                or toks.dtype == torch.bool:
            raise PreflightError(
                f"calibration batch {i}: tokens dtype {toks.dtype} is not "
                f"an integer type")
        lo, hi = (int(toks.min()), int(toks.max())) if toks.numel() \
            else (0, 0)
        if toks.numel() and (lo < 0 or hi >= cfg.vocab_size):
            raise PreflightError(
                f"calibration batch {i}: token ids span [{lo}, {hi}] but "
                f"vocab_size is {cfg.vocab_size}")
        seqs.add(toks.shape[1])
        n_tokens += toks.numel()
        if "labels" in b:
            lab = torch.as_tensor(b["labels"])
            if lab.shape != toks.shape:
                raise PreflightError(
                    f"calibration batch {i}: labels shape "
                    f"{tuple(lab.shape)} != tokens shape "
                    f"{tuple(toks.shape)}")
        if cfg.family == "vlm":
            if "image_embeds" not in b:
                raise PreflightError(
                    f"calibration batch {i}: vlm family needs "
                    f"'image_embeds' in every batch")
            if not bool(torch.isfinite(
                    torch.as_tensor(b["image_embeds"]).float()).all()):
                raise PreflightError(
                    f"calibration batch {i}: image_embeds contain "
                    f"non-finite values")
    if len(seqs) != 1:
        raise PreflightError(
            f"calibration batches mix sequence lengths {sorted(seqs)} — "
            f"the activation streams need one consistent length")
    return n_tokens


def _check_params(params) -> None:
    bad: List[str] = []
    for path, leaf in util.leaves_with_path(params):
        if leaf.is_floating_point() \
                and not bool(torch.isfinite(leaf).all()):
            bad.append(path)
            if len(bad) >= 5:
                break
    if bad:
        raise PreflightError(
            "teacher params contain non-finite values in: "
            + ", ".join(bad)
            + " — a NaN teacher poisons every quantized block; re-export "
              "or re-train the checkpoint before quantizing")


def _available_bytes(device) -> int:
    """Free bytes where the pipeline's working set lives: the card's free
    memory for a CUDA device, the host's ``MemAvailable`` otherwise (0
    when unknown)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 0


def estimate_block_bytes(cfg, calib_batches) -> int:
    """Rough per-block working set: the three activation streams (X_q,
    X_fp, Y) in f32, the VLM's image embeddings (the cross blocks' second
    input, held beside the streams in their own dtype), the largest
    block's params twice (FP and the tuned copy) and LB-ADMM's factor
    state (about 3x the largest linear)."""
    n_rows = sum(int(b["tokens"].shape[0]) for b in calib_batches)
    seq = int(calib_batches[0]["tokens"].shape[1])
    acts = 3 * n_rows * seq * cfg.d_model * 4
    acts += sum(int(b["image_embeds"].numel())
                * b["image_embeds"].element_size()
                for b in calib_batches if "image_embeds" in b)
    # the largest linear of any block: d_model x max(d_ff, d_model)
    widest = max(getattr(cfg, "d_ff", cfg.d_model), cfg.d_model)
    block_params = 4 * cfg.d_model * widest * 4        # a few big linears
    admm_state = 3 * cfg.d_model * widest * 4
    return acts + 2 * block_params + admm_state


def preflight(params, cfg, calib_batches) -> Dict[str, Any]:
    """Validate the quantization inputs; raises :class:`PreflightError`
    on the first failure, returns a small summary on success."""
    n_tokens = _check_calib(cfg, calib_batches)
    _check_params(params)
    need = estimate_block_bytes(cfg, calib_batches)
    device = params["embed"].device
    avail = _available_bytes(device)
    if avail and need > avail:
        raise PreflightError(
            f"estimated per-block working set {need / 2**20:.0f} MiB "
            f"exceeds the free memory of {device} ({avail / 2**20:.0f} "
            f"MiB) — shrink the calibration set (--calib-samples / "
            f"--calib-seq) or free memory")
    return {"n_batches": len(calib_batches), "n_calib_tokens": n_tokens,
            "est_block_bytes": need, "available_bytes": avail,
            "device": str(device)}
