#!/usr/bin/env python3
"""Quantize llama-3.2-vision-90b at full width on one CUDA card, cut to
two layers, and time each block by part.

    python3 scripts/vlm_quant_probe.py

The model at its published widths (d 8192, 64 heads over 8 kv heads,
d_ff 28672, 1024 image tokens) cut to ``chip_smoke.QUANT_DEPTH``'s 2
layers grouped as one: one self-attention block, then one gated
cross-attention block (the repo's SMOKE grouping). The run is
``chip_smoke.py``'s VLM quantize phase alone:
the kernels built from the checkout, #4 under the KD autograd Function at
the FFN's shape (``chip_smoke.check_autograd(twocall=True)``), then
``chip_smoke.quantize_path`` in bf16 with ``QuantConfig()`` on
``chip_smoke.QUANT``'s 16 x 256 calibration tokens and 16 x 1024 seeded
image embeddings, the teacher's gates under ``testing.GATE_LAWS``: each
block's seconds by part (TuneFP, LB-ADMM per linear, STE, packing, the
rest; ``chip_smoke.block_parts``), KD, peak GiB, the launches of #1 and
#4; then the artifact served in f32 (``chip_smoke.quantize_serve``: the
engine and ``generate`` with seeded images) and ``python -m
repro_torch.launch.serve`` without an artifact and with ``--fp``. Prints
the card's name and power limit first; the record goes to
``vlm_quant_probe.json`` in ``chip_smoke.OUT_DIR``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("vlm_quant_probe: no CUDA device is available")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    cs.log(smi)
    arch = "llama-3.2-vision-90b"
    depth = cs.QUANT_DEPTH[arch]
    report = {"device": smi, "depth": depth, "build_s": build.build_all()}
    cs.log(f"build: {report['build_s']:.1f} s")
    report["twocall_autograd"] = cs.check_autograd(twocall=True)
    launches = {}
    report["quantize"], art = cs.quantize_path(arch, launches, depth)
    report["quantized"] = cs.quantize_serve(arch, art, launches)
    report["serve_demo"] = cs.serve_demo_paths()
    report["launches"] = launches
    report["script_s"] = time.perf_counter() - t0
    cs.log(f"probe: {report['script_s']:.1f} s on {smi}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "vlm_quant_probe.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
