#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build  — the three CUDA kernels of ``src/repro_torch/csrc`` built with
   nvcc for sm_90a (one process per source, started together);
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the llama3.2-1b serving path gives it (decode M in {1, 8},
   prefill M = 512; B = 8 slots, page_size 64, ragged block tables, null
   padding, one slot with an all-null table), f32 and bf16, with the
   reference harness's tolerances (relative max-abs 1e-5 f32, 3e-2 bf16);
   device times (CUDA events, median of 21) of the kernel, its plain
   version and one PyTorch call computing the same function (a yardstick,
   never used by the port);
4. engine — full-width, full-depth llama3.2-1b at 1.0 bpw with packed
   weights drawn from a seed, served by the continuous-batching engine
   (8 slots, max_len 256, 8 requests of 17-200 prompt tokens and 32 new
   tokens, admitted mid-flight), once with the decode megakernel and once
   without, each gated against the same engine on the plain oracles
   (greedy tokens identical, or a divergence at a plain-path top-2 logit
   margin below the logits tolerance); then a bf16 run for tok/s and TTFT,
   and the same run under torch.profiler for the device's busy share;
5. the ``kernels`` JSON line, then the ``ok`` JSON line.

Details go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
SEED = 0
HBM_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_S = 67e12            # H100 SXM f32 outside the tensor cores
TOL = {"f32": 1e-5, "bf16": 3e-2}
LOGITS_TOL = 1e-4
SLEEP_CYCLES = 20_000_000     # ~10 ms: holds the card while one timed call queues


def log(msg):
    print(msg, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401 — fails outside a checkout of the repo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    from repro_torch.kernels import build
    secs = build.build_all()
    log(f"build: {secs:.1f} s (nvcc, sm_90a, {len(build.SOURCES)} sources "
        f"in parallel)")
    report["build_s"] = secs

    model32 = make_model(torch.float32)
    kernels = check_kernels(model32, report)
    engine_phase(model32, kernels, report)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# model, timing, comparison
# ---------------------------------------------------------------------------


def make_model(dtype):
    """llama3.2-1b at 1.0 bpw, packed words and scales from the seed."""
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_config
    from repro_torch.quant.surgery import abstract_quantized_params
    from repro_torch.testing import random_packed_params
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype=name)
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0), SEED)
    return NanoQuantModel.from_numpy(tree, cfg, device="cuda", dtype=dtype)


def time_ms(fn, reps=21, warmup=3):
    """Median device time of one fn() call over `reps` calls, in ms. Before
    each call the card is held busy (``torch.cuda._sleep``) until the host
    has enqueued the call and its pair of events, so the events bracket
    device work only and not the host's launch overhead. A sample whose
    enqueueing outlasted the sleep is retaken with a sleep twice as long.
    One call at a time: a longer queue fills the card's launch queue and
    blocks the host."""
    import torch
    for _ in range(warmup):
        fn()
    times, cycles = [], SLEEP_CYCLES
    while len(times) < reps:
        start, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        torch.cuda.synchronize()
        start.record()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        b.synchronize()
        sleep_ms = start.elapsed_time(a)
        if enqueue_ms > sleep_ms:
            if cycles >= 16 * SLEEP_CYCLES:
                raise AssertionError(f"timing: enqueueing took {enqueue_ms:.2f}"
                                     f" ms, longer than the {sleep_ms:.2f} ms "
                                     f"sleep")
            cycles *= 2
            continue
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(what, want, got, tol):
    """Relative max-abs error (scale max(1, max|want|)); raises past tol."""
    import torch
    assert want.shape == got.shape, (what, want.shape, got.shape)
    a, b = want.float(), got.float()
    if not torch.isfinite(b).all():
        raise AssertionError(f"{what}: kernel output not finite")
    abs_err = float((a - b).abs().max())
    rel = abs_err / max(1.0, float(a.abs().max()))
    if rel > tol:
        raise AssertionError(f"{what}: rel err {rel:.3e} > {tol}")
    return abs_err, rel


def bound(bytes_moved, flops):
    t_bytes, t_ops = bytes_moved / HBM_BYTES_S, flops / F32_FLOPS_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def lowrank_cost(K, dims, M):
    """Packed-weight bytes and f32 operations of M rows through low-rank
    binary linears of input width K and (rank, d_out) ``dims``, counting
    each linear at its own rank and output width: the padding that a
    merged group adds (rank up to the widest, masked by ``rmask``; output
    up to the widest, s1 = 0) is work the function does not need."""
    w_bytes = sum(4 * (K // 32 * r + -(-r // 32) * n + n + K)
                  for r, n in dims)
    flops = sum(2.0 * M * (K * r + r * n) for r, n in dims)
    return w_bytes, flops


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def layer0(model):
    from repro_torch.quant.surgery import merge_projection_groups
    from repro_torch.models.transformer import split_layers
    return split_layers(merge_projection_groups(model.params))["layers"][0]


def check_kernels(model, report):
    import torch
    from repro_torch.kernels import binary_matmul, megakernel, paged_attention
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lp = layer0(model)
    cfg = model.cfg
    groups = {"qkv": (lp["attn"]["wqkv"], ("wq", "wk", "wv")),
              "wo": (_group(lp["attn"]["wo"]), ("wo",)),
              "gate_up": (lp["ffn"]["wgu"], ("w_gate", "w_up")),
              "down": (_group(lp["ffn"]["w_down"]), ("w_down",))}
    rows, line = [], {}
    for name, (g, members) in groups.items():
        G, KW, R = g["qv"].shape
        N = g["qu_t"].shape[-1]
        dims = [_dims(lp, nm) for nm in members]
        for m in (1, 8, 512):
            for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                x = torch.randn((1, m, KW * 32), generator=gen, device="cuda"
                                ).to(tdt)
                args = (x, g["qv"], g["qu_t"], g["s1"], g["s2"], g["rmask"])

                def kern():
                    return binary_matmul.fused_lowrank_matmul_grouped(
                        *args, x_shared=True)

                def plain():
                    return binary_matmul.fused_lowrank_matmul_grouped_ref(
                        *args, x_shared=True)
                abs_err, rel = compare(f"fused_lowrank {name} M={m} {dt}",
                                       plain(), kern(), TOL[dt])
                V = torch.stack([ref.unpack_signs(w) for w in g["qv"]]).to(tdt)
                U = torch.stack([ref.unpack_signs(w) for w in g["qu_t"]]
                                ).to(tdt)
                s2, s1 = g["s2"][:, None].to(tdt), g["s1"][:, None].to(tdt)
                rm = g["rmask"][:, None].to(tdt)

                def library():
                    return torch.matmul(torch.matmul(x * s2, V) * rm, U) * s1
                rec = {"kernel": "fused_lowrank_matmul_grouped", "group": name,
                       "G": G, "M": m, "K": KW * 32, "R": R, "N": N,
                       "dtype": dt, "max_abs_err": abs_err, "rel_err": rel,
                       "ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "library_ms": time_ms(library)}
                w_bytes, flops = lowrank_cost(KW * 32, dims, m)
                io = nbytes(x) + sum(m * n for _, n in dims) * x.element_size()
                rec["bound_ms"], rec["bound_by"] = bound(w_bytes + io, flops)
                rows.append(rec)
                log(f"kernel fused_lowrank {name:8s} M={m:<4d} {dt:4s} "
                    f"rel_err={rel:.2e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.5f}")
                if (name, m, dt) == ("gate_up", 8, "f32"):
                    line["fused"] = rec

    paged_rows, mega_rows = [], []
    for dt, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        case = _paged_case(cfg, tdt, gen)
        rec = _check_paged(case, cfg, dt)
        paged_rows.append(rec)
        if dt == "f32":
            line["paged"] = rec
        rec = _check_mega(case, lp, cfg, dt)
        mega_rows.append(rec)
        if dt == "f32":
            line["mega"] = rec
    report["kernel_checks"] = rows + paged_rows + mega_rows
    return [
        _entry("fused_lowrank_matmul_grouped", "src/repro_torch/csrc/"
               "binary_matmul.cu", "src/repro/kernels/binary_matmul.py:183",
               line["fused"]),
        _entry("paged_decode_attention", "src/repro_torch/csrc/"
               "paged_attention.cu", "src/repro/kernels/paged_attention.py:117",
               line["paged"]),
        _entry("decode_step_megakernel_raw", "src/repro_torch/csrc/"
               "megakernel.cu", "src/repro/kernels/megakernel.py:195",
               line["mega"]),
    ]


def _dims(lp, name):
    """(rank, d_out) of layer ``lp``'s unmerged packed linear ``name``."""
    p = (lp["attn"] if name in lp["attn"] else lp["ffn"])[name]
    return int(p["qv"].shape[-1]), int(p["qu_t"].shape[-1])


def _group(p):
    import torch
    return {"qv": p["qv"][None], "qu_t": p["qu_t"][None],
            "s1": p["s1"][None].float(), "s2": p["s2"][None].float(),
            "rmask": torch.ones((1, p["qv"].shape[-1]), device="cuda")}


def _entry(name, source, replaces, rec):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0,
            "max_abs_err": rec["max_abs_err"], "max_err": rec["rel_err"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": {k: rec[k] for k in rec if k in
                      ("group", "G", "M", "K", "R", "N", "B", "pages",
                       "dtype")}}


def _paged_case(cfg, tdt, gen):
    """B = 8 slots over a pool of 64-row pages sized for max_len 256:
    ragged tables (1-4 pages), null-page padding, slot 7 all-null."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED + 1)
    B, PS, pages = 8, 64, 4
    n_pages = B * pages + 1
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    kp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    vp = torch.randn((n_pages, PS, hkv, hd), generator=gen, device="cuda"
                     ).to(tdt)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = np.zeros((B, pages), np.int32)
    pos = np.zeros(B, np.int32)
    used = 0
    for b in range(B - 1):
        k = int(rng.integers(1, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        pos[b] = int(rng.integers((k - 1) * PS, k * PS))
    return {"k_pool": kp, "v_pool": vp,
            "block_table": torch.from_numpy(bt).cuda(),
            "pos": torch.from_numpy(pos).cuda(), "valid_rows": int(
                (pos + 1).sum()), "B": B, "pages": pages}


def _check_paged(case, cfg, dt):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention, ref
    B, hq, hkv, hd = case["B"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    q = torch.randn((B, 1, hq, hd), device="cuda").to(kp.dtype)
    bt, pos = case["block_table"], case["pos"]
    scale = 1.0 / math.sqrt(hd)
    args = (q, kp, vp, bt, pos, pos)

    def kern():
        return paged_attention.paged_decode_attention(*args, scale=scale)

    def plain():
        return ref.paged_attention_ref(*args, scale=scale)
    abs_err, rel = compare(f"paged_attention {dt}", plain(), kern(), TOL[dt])
    # yardstick: SDPA over the pages gathered beforehand, same mask
    rows = bt.shape[1] * kp.shape[1]
    kg = kp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    mask = (torch.arange(rows, device="cuda")[None, :] <= pos[:, None].long()
            )[:, None, None, :]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    rec = {"kernel": "paged_decode_attention", "B": B, "pages": bt.shape[1],
           "dtype": dt, "max_abs_err": abs_err, "rel_err": rel,
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "library_ms": time_ms(library)}
    kv_bytes = case["valid_rows"] * hkv * hd * 2 * kp.element_size()
    b = kv_bytes + 2 * nbytes(q) + nbytes(bt) + 2 * nbytes(pos)
    rec["bound_ms"], rec["bound_by"] = bound(
        b, 4.0 * hq * hd * case["valid_rows"])
    log(f"kernel paged_attention B={B} {dt:4s} rel_err={rel:.2e} "
        f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.5f}")
    return rec


def _check_mega(case, lp, cfg, dt):
    import torch
    from repro_torch.kernels import megakernel, ref
    B, hd = case["B"], cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    x = torch.randn((B, cfg.d_model), device="cuda").to(kp.dtype)
    mqkv, wo = lp["attn"]["wqkv"], lp["attn"]["wo"]
    bt, pos = case["block_table"], case["pos"]
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    kw = dict(dims=(nq, nkv), head_dim=hd, theta=cfg.rope_theta,
              scale=1.0 / math.sqrt(hd))
    args = (x, mqkv, wo, kp, vp, bt, pos, pos)

    def kern():
        return megakernel.decode_step_megakernel_raw(*args, **kw)

    def plain():
        return ref.decode_step_ref(*args, **kw)
    got, want = kern(), plain()
    errs = [compare(f"megakernel {nm} {dt}", w, g, TOL[dt])
            for nm, w, g in zip(("y", "k_new", "v_new"), want, got)]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    rec = {"kernel": "decode_step_megakernel_raw", "B": B,
           "pages": bt.shape[1], "dtype": dt, "max_abs_err": abs_err,
           "rel_err": rel, "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "library_ms": None}
    K, Ko = mqkv["qv"].shape[1] * 32, wo["qv"].shape[0] * 32
    qkv_bytes, qkv_flops = lowrank_cost(
        K, [_dims(lp, nm) for nm in ("wq", "wk", "wv")], B)
    wo_bytes, wo_flops = lowrank_cost(Ko, [_dims(lp, "wo")], B)
    kv_bytes = case["valid_rows"] * nkv * 2 * kp.element_size()
    io = (nbytes(x, bt, pos) + B * cfg.d_model * x.element_size()
          + B * 2 * nkv * kp.element_size())
    flops = qkv_flops + wo_flops + 4.0 * cfg.n_heads * hd * case["valid_rows"]
    rec["bound_ms"], rec["bound_by"] = bound(
        qkv_bytes + wo_bytes + kv_bytes + io, flops)
    log(f"kernel megakernel B={B} {dt:4s} rel_err={rel:.2e} "
        f"ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f}")
    return rec


# ---------------------------------------------------------------------------
# phase 4: the serving engine
# ---------------------------------------------------------------------------


def _requests(cfg):
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(17, 201, size=8)
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int64)
            for n in lens]


def serve(model, policy, megakernel=None):
    """8 requests, 5 submitted up front and 3 after eight engine steps
    (mid-flight admission). Returns (outputs, engine, wall seconds)."""
    import torch
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.scheduler import Request
    eng = model.engine(ServeConfig(greedy=True, page_size=64,
                                   megakernel=megakernel, debug=True),
                       max_batch=8, max_len=256, policy=policy)
    prompts = _requests(model.cfg)
    t0 = time.perf_counter()
    for uid in range(5):
        eng.submit(Request(uid, prompts[uid], max_new_tokens=32))
    for _ in range(8):
        eng.step()
    for uid in range(5, 8):
        eng.submit(Request(uid, prompts[uid], max_new_tokens=32))
    done = eng.run()
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(8)) or eng.kv.used_pages != 0:
        raise AssertionError("engine did not finish every request cleanly")
    for uid, r in done.items():
        if len(r.output) != 32:
            raise AssertionError(f"request {uid}: {len(r.output)} tokens")
    return {u: r.output for u, r in done.items()}, eng, wall


def _margin(model, prompt, prefix):
    """Top-2 logit margin and tolerance of the plain path at the step
    that produced the next token after `prefix` (teacher-forced)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ops import KernelPolicy, kernel_policy
    from repro_torch.models import transformer as TT
    toks = np.concatenate([prompt, np.asarray(prefix, np.int64)])[None]
    with kernel_policy(KernelPolicy(mode="ref")), torch.inference_mode():
        lg = TT.forward(model.params, model.cfg,
                        torch.from_numpy(toks).to(model.device))[0, -1]
    lg = lg.float()
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1]), LOGITS_TOL * max(1.0, float(lg.abs().max()))


def gate(model, name, got, want):
    """Identical greedy tokens, or a first divergence at a near-tie of
    the plain path (top-2 margin below the logits tolerance)."""
    prompts = _requests(model.cfg)
    worst = None
    for uid in sorted(want):
        diff = [i for i, (a, b) in enumerate(zip(want[uid], got[uid]))
                if a != b]
        if not diff:
            continue
        i = diff[0]
        margin, tol = _margin(model, prompts[uid], want[uid][:i])
        log(f"engine {name}: request {uid} diverges at token {i}: plain-path "
            f"top-2 margin {margin:.3e} (tolerance {tol:.3e})")
        if margin >= tol:
            raise AssertionError(f"engine {name}: request {uid} token {i} "
                                 f"differs at a margin past the tolerance")
        worst = max(worst or 0.0, margin)
    return worst


# the serving paths chip_smoke drives (ServeConfig.megakernel) and the
# kernels (indices into the ``kernels`` line) each must launch
PATHS = (("megakernel", True, (0, 2)), ("unfused", False, (0, 1)))


def engine_phase(model32, kernels, report):
    import torch
    from repro_torch.kernels import binary_matmul, megakernel, paged_attention
    from repro_torch.kernels.ops import KernelPolicy
    counters = (binary_matmul.fused_lowrank_matmul_grouped,
                paged_attention.paged_decode_attention,
                megakernel.decode_step_megakernel_raw)
    want, _, ref_wall = serve(model32, KernelPolicy(mode="ref"))
    runs, per_path = {}, {}
    for name, mk, needed in PATHS:
        for c in counters:
            c.launches = 0
        runs[name] = serve(model32, KernelPolicy(mode="cuda"), mk)
        per_path[name] = [c.launches for c in counters]
        log(f"engine path {name}: launches " + ", ".join(
            f"{k['name']}={n}" for k, n in zip(kernels, per_path[name])))
        missing = [kernels[i]["name"] for i in needed
                   if per_path[name][i] == 0]
        if missing:
            raise AssertionError(f"engine path {name}: {missing} never "
                                 f"launched")
    for i, k in enumerate(kernels):
        k["launches_by_path"] = {p: n[i] for p, n in per_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())
    res = {"ref_wall_s": ref_wall, "launches_by_path": per_path}
    for name, (got, eng, wall) in runs.items():
        margin = gate(model32, name, got, want)
        st = eng.stats
        res[name] = {"wall_s": wall, "max_divergence_margin": margin,
                     "stats": st}
        log(f"engine f32 {name}: tokens match the plain path"
            + ("" if margin is None else " up to near-ties")
            + f"; {st['tokens_emitted']} tokens, {st['decode_steps']} decode "
            f"steps, {st['preemptions']} preemptions, wall {wall:.2f} s")
    model16 = make_model(torch.bfloat16)
    got, eng, wall = serve(model16, KernelPolicy(mode="cuda"))
    st = eng.stats
    ttft = sorted(h.ttft for h in eng.handles.values())
    decode_tokens = st["tokens_emitted"] - st["admissions"]
    res["bf16"] = {"wall_s": wall, "decode_tok_s": decode_tokens
                   / st["decode_time_s"], "ttft_s": ttft, "stats": st}
    log(f"engine bf16 megakernel on {report['device']}: decode "
        f"{res['bf16']['decode_tok_s']:.1f} tok/s, TTFT median "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f} ms), "
        f"wall {wall:.2f} s")
    res["bf16_profile"] = profile_engine(model16, wall)
    report["engine"] = res


def profile_engine(model, wall):
    """The bf16 engine run once more under torch.profiler: device time by
    kernel and the device's busy share of the unprofiled run's wall time
    (one stream, so kernel times add up without overlap)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        serve(model, KernelPolicy(mode="cuda"))
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)
    busy_s = sum(e.self_device_time_total for e in dev) * 1e-6
    if busy_s == 0:
        log("engine bf16 profile: device time not measured (the profiler "
            "recorded no device events)")
        return None
    top = [{"kernel": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total * 1e-3} for e in dev[:10]]
    log(f"engine bf16 profile: device busy {busy_s:.3f} s of the {wall:.3f} s "
        f"unprofiled wall ({100 * busy_s / wall:.1f}%); top: "
        + "; ".join(f"{t['kernel'][:40]} x{t['calls']} {t['device_ms']:.1f} ms"
                    for t in top[:5]))
    return {"device_busy_s": busy_s, "wall_s": wall, "top": top}


if __name__ == "__main__":
    main()
