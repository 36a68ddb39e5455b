#!/usr/bin/env python3
"""Tensor-parallel serving over NCCL with a card per rank: the
tensor-parallel phases of ``chip_smoke.py`` (``TP_PHASES``) with
``backend="nccl"``, rank r on card r, instead of gloo ranks sharing one
card. By default the phases qwen1.5-110b at TP 2 and llama3.2-1b at TP 4
(plain then self-speculative); ``--arch A`` (repeatable) runs A's phase
instead, at ``--tp`` ranks (4 by default: qwen3-moe-235b-a22b then holds
32 experts and one kv head per rank, llama-3.2-vision-90b 2 of its 8 kv
heads). f32, full width at ``DEPTH``. It needs a card per rank;
``--backend gloo`` runs the ranks on card 0 instead, as ``chip_smoke.py``
does, to check a phase alone.

    python3 scripts/tp_nccl_probe.py
    python3 scripts/tp_nccl_probe.py --arch qwen3-moe-235b-a22b --tp 4
    python3 scripts/tp_nccl_probe.py --arch llama-3.2-vision-90b --tp 4

The kernels are built first; the unsharded engine paths of each phase's
model run on card 0 and give the tokens each TP path is gated against
(identical, or a divergence at a plain-path near-tie; an MoE's through
``moe_gate``; the VLM's image forward against its plain path's logits),
then each phase starts its ranks. Every rank checks its
launches and collectives against its family's template, as in
``chip_smoke.py``. It prints the card's name and power limit, each
path's line (host ms per decode step, here with each collective over
NCCL) and the phases' seconds; the records go to
``chiprun_out/tp_nccl_probe.json``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def phases(cs, archs, n):
    """The TP phases to run: ``TP_PHASES``' first two, or each of `archs`'
    phase renamed and resized to `n` ranks."""
    if not archs:
        return cs.TP_PHASES[:2]
    out = []
    for arch in archs:
        runs = next((r for _, a, _, r in cs.TP_PHASES if a == arch), None)
        if runs is None:
            sys.exit(f"tp_nccl_probe: no tensor-parallel phase serves {arch}")
        name = f"{arch}-tp{n}"
        out.append((name, arch, n, [
            (f"{name}{path[len(arch) + 4:]}", traffic, spec, versus)
            for path, traffic, spec, versus in runs]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=[],
                    help="run this arch's TP phase (repeatable; default: "
                         "qwen1.5-110b at TP 2 and llama3.2-1b at TP 4)")
    ap.add_argument("--tp", type=int, default=4,
                    help="ranks of --arch's phase, a card each")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                    help="nccl: a card per rank; gloo: every rank on card 0")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import chip_smoke as cs
    todo = phases(cs, args.arch, args.tp)
    cards = 1 if args.backend == "gloo" \
        else max(n for _, _, n, _ in todo)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        sys.exit(f"tp_nccl_probe: needs {cards} CUDA cards")
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
    paths = {p[0]: p[1] for p in cs.PATHS}
    for _, arch, _, runs in todo:
        traffic = paths[runs[0][3]]
        model = cs.make_llama() if arch == "llama3.2-1b" \
            else cs.make_on_card(arch)
        cs.serve_paths(model, traffic, launches)
        if model.cfg.family == "vlm":
            cs.vision_image_path(model, launches)
        del model
        cs.free()
    report["unsharded_s"] = time.perf_counter() - t0
    for name, arch, n, runs in todo:
        report.update(cs.tp_phase([(name, arch, runs)], n, launches,
                                  backend=args.backend))
        cs.log(f"{name}: {report[name]['phase_s']:.1f} s over "
               f"{args.backend}, devices {report[name]['devices']}")
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "tp_nccl_probe.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)


if __name__ == "__main__":
    main()
