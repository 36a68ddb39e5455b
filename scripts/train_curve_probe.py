#!/usr/bin/env python3
"""Loss curves of the port's trainer on llama3.2-1b at full width, cut to
4 of its 16 layers (bf16, f32 AdamW, 8 x 256 synthetic tokens a step),
under the quantize CLI's teacher recipe and three variants of it.

    python3 scripts/train_curve_probe.py [--device cuda]

For each recipe it prints the first-10 and last-10 mean losses, their
difference, the lowest loss and the means of every 10 steps, beside the
card's name and power limit; the records go to
``chiprun_out/train_curve_probe.json``. The synthetic chain over 128256
tokens has ln 128256 = 11.76 nats of unigram entropy, and its transitions
are seen about twice each in a few hundred steps, so the curves show how
far a teacher falls from its init loss toward that floor.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (lr, total_steps): the CLI's recipe at 150 steps, at 200 and 300, and
# launch.train's default lr
RECIPES = ((1e-3, 150), (1e-3, 200), (1e-3, 300), (3e-4, 150))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import train_iterator
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = "cpu"
    if args.device != "cpu":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=4)
    out = []
    for lr, total in RECIPES:
        tcfg = TrainConfig(lr=lr, warmup=20, total_steps=total)
        state = init_train_state(cfg, tcfg, device=args.device)
        step = make_train_step(cfg, tcfg)
        it = train_iterator(cfg, 8, 256)
        losses = []
        t0 = time.perf_counter()
        for _ in range(total):
            batch = {k: v.to(args.device) for k, v in next(it).items()}
            *state, m = step(*state, batch)
            losses.append(m["loss"])
        losses = [float(x) for x in losses]
        wall = time.perf_counter() - t0
        first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
        per10 = [sum(losses[i:i + 10]) / 10 for i in range(0, total, 10)]
        out.append({"lr": lr, "total_steps": total, "warmup": 20,
                    "first10": first, "last10": last, "drop": first - last,
                    "min": min(losses), "per10": per10, "wall_s": wall,
                    "device": smi})
        print(f"lr {lr} total_steps {total}: first-10 mean {first:.4f}, "
              f"last-10 mean {last:.4f}, drop {first - last:.4f}, lowest "
              f"{min(losses):.4f}; {wall:.1f} s on {smi}", flush=True)
        print("  10-step means " + " ".join(f"{x:.3f}" for x in per10),
              flush=True)
        del state
        if args.device != "cpu":
            torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_curve_probe.json"),
              "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
