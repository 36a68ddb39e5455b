#!/usr/bin/env python3
"""Tensor-parallel serving over NCCL with a card per rank: the
tensor-parallel phases of ``chip_smoke.py`` (``TP_PHASES``:
qwen1.5-110b at TP 2 under its traffic, llama3.2-1b at TP 4 under its
traffic, plain then self-speculative; f32, full width at ``DEPTH``) with
``backend="nccl"``, rank r on card r, instead of gloo ranks sharing one
card. It needs four cards.

    python3 scripts/tp_nccl_probe.py

The kernels are built first; the unsharded llama3.2-1b and qwen1.5-110b
engine paths run on card 0 and give the tokens each TP path is gated
against (identical, or a divergence at a plain-path near-tie), then each
phase starts its ranks. Every rank checks its launches and collectives
against the template, as in ``chip_smoke.py``. It prints the card's name
and power limit, each path's line (host ms per decode step, here with
each collective over NCCL) and the phases' seconds; the records go to
``chiprun_out/tp_nccl_probe.json``.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDS = 4


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available() or torch.cuda.device_count() < CARDS:
        sys.exit(f"tp_nccl_probe: needs {CARDS} CUDA cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    cs.log("\n".join(smi))
    from repro_torch.kernels import build
    report = {"device": smi, "build_s": build.build_all()}
    launches = {}
    t0 = time.perf_counter()
    llama = cs.make_llama()
    cs.serve_paths(llama, cs.LLAMA, launches)
    del llama
    qwen = cs.make_on_card("qwen1.5-110b")
    cs.serve_paths(qwen, cs.QWEN, launches)
    del qwen
    cs.free()
    report["unsharded_s"] = time.perf_counter() - t0
    for name, arch, n, runs in cs.TP_PHASES:
        report[name] = cs.tp_phase(arch, n, runs, launches, backend="nccl")
        cs.log(f"{name}: {report[name]['phase_s']:.1f} s over NCCL, "
               f"devices {report[name]['devices']}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "tp_nccl_probe.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
