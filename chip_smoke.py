#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure exits non-zero:

1. device — the card's name and power limit, as nvidia-smi reports them;
2. build  — the four CUDA kernels of ``src/repro_torch/csrc`` built with
   nvcc for sm_90a (one process per source, started together);
3. llama3.2-1b kernels — kernels #1-#3 against their plain PyTorch
   versions on the card at the shapes the llama3.2-1b serving path gives
   them (decode M in {1, 8}, prefill M = 512; B = 8 slots, page_size 64,
   ragged block tables, null padding, one slot with an all-null table),
   f32 and bf16, with the reference harness's tolerances (relative
   max-abs 1e-5 f32, 3e-2 bf16); device times (CUDA events, median of
   21) of the kernel, its plain version and one PyTorch call computing
   the same function (a yardstick, never used by the port); the launch
   plan and the achieved share of the bound: ±1 products (#1, #4 and
   #3's projections) counted at the 989 TFLOP/s bf16 tensor rate the
   exact ±1 factors allow, in both dtypes, attention arithmetic (#2 and
   #3's walk) at the rate of the unit it runs on (bf16: the tensor cores;
   f32: the 67 TFLOP/s of the CUDA cores);
   for #1 and #4 also the instruction their ±1 products run on. #2 and
   #3 again at 32 table entries per slot (2048 rows, data from their own
   generator); #3 also with L2 flushed before each call (the engine
   finds its weights cold) and beside the unfused chain it replaces at
   the same inputs (#1 qkv, RoPE, #2, #1 wo; ``chain_ms``, a yardstick);
   then the speculative path's shapes: #1's merged QKV at the verify's
   M = 40, #3 on the draft view (eff_rank 480 of the QKV group's 992 and
   of wo's 992), #2 as the verify reads it (5 queries per slot through
   ``ops.paged_attention`` over a pool with stale rows past the
   frontier);
4. llama3.2-1b engine — full-width, full-depth llama3.2-1b at 1.0 bpw
   with packed weights drawn from a seed, served by the
   continuous-batching engine (8 slots, max_len 256, 8 requests of
   17-200 prompt tokens and 32 new tokens, admitted mid-flight) on four
   paths: ``megakernel``, ``unfused`` (megakernel off), ``twocall``
   (``KernelPolicy(fused=False)``: every packed linear through two
   packed_matmul launches) and ``spec`` (self-speculative decoding, the
   draft at half of every rank, k = 4, megakernel on), each gated against
   the same engine on the plain oracles (``spec`` against ``megakernel``):
   greedy tokens identical, or a divergence at a plain-path top-2 logit
   margin below the logits tolerance; a speculative path must also have
   rolled back drafted tokens and account for every one; then plain
   against speculative decoding in bf16: plain, spec, plain, spec in this
   process (the first plain run gives the ``bf16`` tok/s and TTFT), each
   one's decode window under torch.profiler (device ms per committed
   token by kernel), and the plain run once more under the profiler for
   the device's busy share;
5. qwen1.5-110b kernels — kernel #4 (packed_matmul) at the four two-call
   stage shapes of the qwen1.5-110b MLP (rank 6976) at M in {1, 8, 64},
   plus an eff_rank view read in place; kernel #1 at its merged-QKV and
   wo shapes (rank 4064); kernel #2 at head_dim 128, 8 query heads per
   kv head; then the speculative path's shapes: #4's two launches of the
   draft's gate (rank 3488 of 6976, read in place) at M = 4 and #1's
   merged QKV at the verify's M = 20;
6. qwen1.5-110b engine — full width and full depth (80 layers) at 1.0
   bpw, weights drawn on the card from the seed: 4 slots, max_len 128,
   4 requests of 16-64 prompt tokens and 16 new tokens, 2 admitted after
   three steps, on the paths ``qwen1.5-110b`` and ``qwen1.5-110b-spec``.
   The f32 runs are gated like the llama paths; then plain against
   speculative decoding in bf16 as for llama (the first plain run gives
   decode tok/s, TTFT and peak memory; the plain decode window's profile
   is the ``bf16_decode_profile``);
7. the seconds each phase took, the ``kernels`` JSON line (launches per
   serving path, each path's counts set to 0 just before its f32 run),
   then the ``ok`` JSON line.

Details go to ``chiprun_out/chip_smoke.json``.
"""
import dataclasses
import gc
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
BF16_TC_FLOPS_S = 989e12       # H100 SXM bf16 tensor cores, dense: the rate
# the exact ±1 bf16 factors of kernels #1 and #4 allow, in both dtypes
TOL = {"f32": 1e-5, "bf16": 3e-2}
LOGITS_TOL = 1e-4
SLEEP_CYCLES = 20_000_000     # ~10 ms: holds the card while one timed call queues
L2_FLUSH_BYTES = 64 << 20     # past the H100's 50 MB L2
LONG_PAGES = 32               # table entries per slot of the long-context rows

# (name, source, TPU kernel it replaces); the order of the kernels line
KERNELS = (
    ("fused_lowrank_matmul_grouped", "src/repro_torch/csrc/binary_matmul.cu",
     "src/repro/kernels/binary_matmul.py:183"),
    ("paged_decode_attention", "src/repro_torch/csrc/paged_attention.cu",
     "src/repro/kernels/paged_attention.py:117"),
    ("decode_step_megakernel_raw", "src/repro_torch/csrc/megakernel.cu",
     "src/repro/kernels/megakernel.py:195"),
    ("packed_matmul", "src/repro_torch/csrc/packed_matmul.cu",
     "src/repro/kernels/binary_matmul.py:78"),
)
FUSED, PAGED, MEGA, PACKED = range(4)

# traffic per model: prompt lengths drawn in [lo, hi), `up_front`
# submitted at once and the rest after `after` engine steps
LLAMA = {"arch": "llama3.2-1b", "n": 8, "lens": (17, 201), "up_front": 5,
         "after": 8, "new": 32, "max_batch": 8, "max_len": 256}
QWEN = {"arch": "qwen1.5-110b", "n": 4, "lens": (16, 65), "up_front": 2,
        "after": 3, "new": 16, "max_batch": 4, "max_len": 128}

# self-speculative decoding: the draft reads half of every packed rank
SPEC = {"spec_rank_frac": 0.5, "spec_k": 4}

# serving paths: (name, traffic, KernelPolicy fields, ServeConfig.megakernel,
# speculative settings, the path whose tokens gate it (None: the engine on
# the plain oracles), kernels that must launch, kernels that must not)
PATHS = (
    ("megakernel", LLAMA, {}, True, None, None, (FUSED, MEGA), ()),
    ("unfused", LLAMA, {}, False, None, None, (FUSED, PAGED), ()),
    ("twocall", LLAMA, {"fused": False}, None, None, None, (PACKED, PAGED),
     (FUSED, MEGA)),
    ("spec", LLAMA, {}, True, SPEC, "megakernel", (FUSED, PAGED, MEGA), ()),
    ("qwen1.5-110b", QWEN, {}, None, None, None, (FUSED, PAGED, PACKED),
     (MEGA,)),
    ("qwen1.5-110b-spec", QWEN, {}, None, SPEC, "qwen1.5-110b",
     (FUSED, PAGED, PACKED), (MEGA,)),
)

# the kernels' names in a profiler trace, and the lm head's matmul
TRACE_NAMES = ((FUSED, "fused_lowrank_kernel"),
               (PAGED, "paged_attention_kernel"), (MEGA, "megakernel"),
               (PACKED, "packed_matmul_kernel"))
GEMM_NAMES = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")


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
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    report = {"device": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    phases, t_phase = {}, [t_start]

    def phase(name):                  # seconds of each phase, for the report
        now = time.perf_counter()
        phases[name] = now - t_phase[0]
        t_phase[0] = now

    from repro_torch.kernels import build
    secs = build.build_all()
    log(f"build: {secs:.1f} s (nvcc, sm_90a, {len(build.SOURCES)} sources "
        f"in parallel)")
    report["build_s"] = secs
    phase("build")

    launches = {}                     # path -> launches of each kernel
    llama = make_llama()
    lines = check_llama_kernels(llama, report)
    phase("llama3.2-1b kernels")
    report["llama3.2-1b"] = serve_paths(llama, LLAMA, launches)
    phase("llama3.2-1b f32 engine paths")
    llama = cast(llama, torch.bfloat16)
    cmp = spec_compare(llama, LLAMA, report)
    report["llama3.2-1b"]["spec_bf16"] = cmp
    report["llama3.2-1b"]["bf16"] = cmp["runs"]["plain"][0]
    report["llama3.2-1b"]["bf16_profile"] = profile_engine(
        llama, LLAMA, report["llama3.2-1b"]["bf16"]["wall_s"])
    del llama
    free()
    phase("llama3.2-1b bf16 runs and profiles")

    qwen = make_qwen()
    lines[PACKED] = check_qwen_kernels(qwen, report)
    phase("qwen1.5-110b kernels")
    report["qwen1.5-110b"] = serve_paths(qwen, QWEN, launches)
    phase("qwen1.5-110b f32 engine paths")
    qwen = cast(qwen, torch.bfloat16)
    free()
    cmp = spec_compare(qwen, QWEN, report)
    report["qwen1.5-110b"]["spec_bf16"] = cmp
    report["qwen1.5-110b"]["bf16"] = cmp["runs"]["plain"][0]
    report["qwen1.5-110b"]["bf16_decode_profile"] = cmp["decode_profile"][
        "plain"]
    del qwen
    free()
    phase("qwen1.5-110b bf16 runs and profiles")

    kernels = []
    for i, (name, source, replaces) in enumerate(KERNELS):
        rec = lines[i]
        by_path = {p: n[i] for p, n in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": rec["max_abs_err"], "max_err": rec["rel_err"],
            "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": {k: rec[k] for k in rec if k in
                      ("model", "group", "stage", "G", "M", "K", "R", "N",
                       "B", "pages", "dtype")},
            **{k: rec[k] for k in ("instruction", "plan", "bound_share",
                                   "chain_ms", "cold_l2_ms", "long_context")
               if k in rec}})
    report["kernels"] = kernels
    report["script_s"] = time.perf_counter() - t_start
    report["phase_s"] = phases
    log("phases: " + ", ".join(f"{k} {v:.1f} s" for k, v in phases.items()))
    log(f"script: {report['script_s']:.1f} s on {smi}")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# ---------------------------------------------------------------------------
# models, timing, comparison
# ---------------------------------------------------------------------------


def make_llama():
    """llama3.2-1b at 1.0 bpw in f32, packed words and scales drawn on the
    host from the seed."""
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_config
    from repro_torch.quant.surgery import abstract_quantized_params
    from repro_torch.testing import random_packed_params
    cfg = dataclasses.replace(get_config("llama3.2-1b"), dtype="float32")
    tree = random_packed_params(abstract_quantized_params(cfg, 1.0), SEED)
    return NanoQuantModel.from_numpy(tree, cfg, device="cuda",
                                     dtype=torch.float32)


def make_qwen():
    """qwen1.5-110b at 1.0 bpw in f32, full width and depth, every leaf
    drawn on the card from the seed (13.5 GB of packed words, 10 GB of
    f32 embedding and lm head)."""
    import torch
    from repro_torch.api import NanoQuantModel
    from repro_torch.configs import get_config
    from repro_torch.quant.surgery import abstract_quantized_params
    from repro_torch.testing import random_packed_params_device
    cfg = dataclasses.replace(get_config("qwen1.5-110b"), dtype="float32")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    tree = random_packed_params_device(abstract_quantized_params(cfg, 1.0),
                                       SEED, "cuda")
    torch.cuda.synchronize()
    log(f"qwen1.5-110b f32 weights drawn on the card: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in "
        f"{time.perf_counter() - t0:.3f} s")
    return NanoQuantModel(tree, cfg)


def cast(model, dtype):
    """The same model with its FP leaves cast to `dtype` (packed words and
    scales shared, not copied); the caller drops the f32 model."""
    from repro_torch.api import NanoQuantModel
    from repro_torch.convert import params_from_numpy
    name = str(dtype).removeprefix("torch.")
    return NanoQuantModel(params_from_numpy(model.params, model.device, dtype),
                          dataclasses.replace(model.cfg, dtype=name))


def free():
    """Release what dropped engines and models held: an engine and its
    request handles refer to each other, so only the cycle collector
    frees an engine's merged weights."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def time_ms(fn, reps=21, warmup=3, flush=None):
    """Median device time of one fn() call over `reps` calls, in ms. Before
    each call the card is held busy (``torch.cuda._sleep``) until the host
    has enqueued the call and its pair of events, so the events bracket
    device work only and not the host's launch overhead. A sample whose
    enqueueing outlasted the sleep is retaken with a sleep twice as long.
    One call at a time: a longer queue fills the card's launch queue and
    blocks the host. ``flush`` (a tensor) is overwritten on the card after
    the sleep and before the first event, so each call finds L2 cold."""
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
        if flush is not None:
            flush.zero_()
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


def bound(bytes_moved, *work):
    """Least device time (ms) of a function that must move `bytes_moved`
    and do the operations of `work`, (flops, the peak rate of the unit
    they run on) pairs, and which of the two bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = sum(flops / rate for flops, rate in work)
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


def _timed(rec, kern, plain, library):
    rec.update(ms=time_ms(kern), plain_ms=time_ms(plain),
               library_ms=None if library is None else time_ms(library))
    return rec


def _dtypes():
    import torch
    return (("f32", torch.float32), ("bf16", torch.bfloat16))


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def layer0(model):
    """Layer 0's views with its merged QKV / gate-up groups added."""
    from repro_torch.models.transformer import split_layers
    from repro_torch.quant.surgery import merge_projection_groups
    return merge_projection_groups(split_layers(model.params)["layers"][0])


def check_llama_kernels(model, report):
    """#1 at every llama3.2-1b shape, #2 and #3 at its decode shape;
    returns the kernels line's records (#4 comes with qwen1.5-110b)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lp = layer0(model)
    cfg = model.cfg
    rows = check_fused(lp, ("qkv", "wo", "gate_up", "down"), (1, 8, 512), gen,
                       "llama3.2-1b")
    line = {FUSED: next(r for r in rows if (r["group"], r["M"], r["dtype"])
                        == ("gate_up", 8, "f32"))}
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=4)
        rec = _check_paged(case, cfg, dt, "llama3.2-1b")
        rows.append(rec)
        if dt == "f32":
            line[PAGED] = rec
        rec = _check_mega(case, lp, cfg, dt)
        rows.append(rec)
        if dt == "f32":
            line[MEGA] = rec
    # long context: 32 entries per slot, from generators of their own so
    # that the rows above see the same data as before these rows existed
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=LONG_PAGES,
                           seed=SEED + 4, min_mapped=LONG_PAGES // 2)
        for i, rec in ((PAGED, _check_paged(case, cfg, dt, "llama3.2-1b")),
                       (MEGA, _check_mega(case, lp, cfg, dt))):
            rows.append(rec)
            if dt == "f32":
                line[i]["long_context"] = {
                    k: rec[k] for k in rec if k in (
                        "pages", "dtype", "ms", "plain_ms", "library_ms",
                        "chain_ms", "cold_l2_ms", "bound_ms", "bound_by",
                        "bound_share", "max_abs_err")}
    report["kernel_checks"] = rows
    # the speculative path's shapes, from a generator of their own: #1's
    # merged QKV at the verify's M = B·(k+1), #3 on the draft view, #2 as
    # the verify reads it (k+1 queries over a pool with stale rows)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    s = SPEC["spec_k"] + 1
    spec_rows = check_fused(lp, ("qkv",), (LLAMA["max_batch"] * s,), gen,
                            "llama3.2-1b")
    for dt, tdt in _dtypes():
        case = _paged_case(cfg, tdt, gen, B=8, pages=4, seed=SEED + 6)
        spec_rows.append(_check_mega(case, lp, cfg, dt, eff=(
            _draft_rank(lp["attn"]["wqkv"]), _draft_rank(lp["attn"]["wo"]))))
        spec_rows.append(_check_paged_verify(case, cfg, dt, s))
    report["spec_kernel_checks"] = spec_rows
    return line


def _draft_rank(p):
    """The rank the draft reads of packed linear (or group) ``p``."""
    from repro_torch.quant.surgery import truncated_rank
    return truncated_rank(p["qv"].shape[-1], SPEC["spec_rank_frac"])


def check_fused(lp, names, ms, gen, model_name):
    """Kernel #1 on layer ``lp``'s packed groups ``names`` at each M."""
    import torch
    from repro_torch.kernels import binary_matmul, ref
    members = {"qkv": ("attn", "wqkv", ("wq", "wk", "wv")),
               "wo": ("attn", "wo", ("wo",)),
               "gate_up": ("ffn", "wgu", ("w_gate", "w_up")),
               "down": ("ffn", "w_down", ("w_down",))}
    rows = []
    for name in names:
        blk, key, lins = members[name]
        g = lp[blk][key] if len(lins) > 1 else _group(lp[blk][key])
        G, KW, R = g["qv"].shape
        N = g["qu_t"].shape[-1]
        dims = [_dims(lp, nm) for nm in lins]
        for dt, tdt in _dtypes():
            V = torch.stack([ref.unpack_signs(w) for w in g["qv"]]).to(tdt)
            U = torch.stack([ref.unpack_signs(w) for w in g["qu_t"]]).to(tdt)
            s2, s1 = g["s2"][:, None].to(tdt), g["s1"][:, None].to(tdt)
            rm = g["rmask"][:, None].to(tdt)
            for m in ms:
                x = torch.randn((1, m, KW * 32), generator=gen, device="cuda"
                                ).to(tdt)
                args = (x, g["qv"], g["qu_t"], g["s1"], g["s2"], g["rmask"])

                def kern():
                    return binary_matmul.fused_lowrank_matmul_grouped(
                        *args, x_shared=True)

                def plain():
                    return binary_matmul.fused_lowrank_matmul_grouped_ref(
                        *args, x_shared=True)

                def library():
                    return torch.matmul(torch.matmul(x * s2, V) * rm, U) * s1
                abs_err, rel = compare(f"fused_lowrank {model_name} {name} "
                                       f"M={m} {dt}", plain(), kern(), TOL[dt])
                rec = _timed({"kernel": "fused_lowrank_matmul_grouped",
                              "model": model_name, "group": name, "G": G,
                              "M": m, "K": KW * 32, "R": R, "N": N,
                              "dtype": dt, "max_abs_err": abs_err,
                              "rel_err": rel}, kern, plain, library)
                w_bytes, flops = lowrank_cost(KW * 32, dims, m)
                io = nbytes(x) + sum(m * n for _, n in dims) * x.element_size()
                rec["bound_ms"], rec["bound_by"] = bound(
                    w_bytes + io, (flops, BF16_TC_FLOPS_S))
                _tensor_core_row(
                    rec, binary_matmul.fused_lowrank_matmul_grouped.plan)
                rows.append(rec)
                log(f"kernel fused_lowrank {model_name} {name:8s} M={m:<4d} "
                    f"{dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} "
                    f"plain_ms={rec['plain_ms']:.4f} "
                    f"library_ms={rec['library_ms']:.4f} "
                    f"bound_ms={rec['bound_ms']:.5f} "
                    f"({100 * rec['bound_share']:.1f}% of it) "
                    f"slices={rec['plan']['slices']} "
                    f"grid={rec['plan']['grid']}")
            del V, U
    return rows


# the two packed_matmul launches of each qwen1.5-110b MLP linear
# (``lowrank_binary_matmul_twocall``): stage 1 reads qv with s_k = s2,
# stage 2 reads qu_t with s_n = s1
STAGES = (("gate_up.1", "w_gate", "qv"), ("gate_up.2", "w_gate", "qu_t"),
          ("down.1", "w_down", "qv"), ("down.2", "w_down", "qu_t"))


def check_qwen_kernels(model, report):
    """#4 at the four qwen1.5-110b two-call stage shapes (M in {1, 8, 64})
    and on an eff_rank view (R' = 4096 of 6976, read in place); #1 at the
    merged-QKV and wo shapes (rank 4064); #2 at head_dim 128, G 8.
    Returns the kernels line's record of #4 (w_down stage 1, M = 8, f32)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lp = layer0(model)
    rows = []
    for stage, lin, leaf in STAGES:
        p = lp["ffn"][lin]
        sk, sn = (p["s2"], None) if leaf == "qv" else (None, p["s1"])
        for m in (1, 8, 64):
            for dt, tdt in _dtypes():
                rows.append(_check_packed(stage, p[leaf], sk, sn, m, dt, tdt,
                                          gen))
    p = lp["ffn"]["w_gate"]
    view = p["qv"][:, :4096]
    for dt, tdt in _dtypes():
        rows.append(_check_packed("gate_up.1 eff_rank 4096", view, p["s2"],
                                  None, 8, dt, tdt, gen))
    rows += check_fused(lp, ("qkv", "wo"), (1, 8, 64), gen, "qwen1.5-110b")
    for dt, tdt in _dtypes():
        rows.append(_check_paged(_paged_case(model.cfg, tdt, gen, B=4,
                                             pages=2),
                                 model.cfg, dt, "qwen1.5-110b"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for dt, tdt in _dtypes():               # long context, own generators
        rows.append(_check_paged(
            _paged_case(model.cfg, tdt, gen, B=4, pages=LONG_PAGES,
                        seed=SEED + 5, min_mapped=LONG_PAGES // 2),
            model.cfg, dt, "qwen1.5-110b"))
    report["qwen_kernel_checks"] = rows
    # the speculative path's shapes: #4's two launches of the draft's
    # gate (rank 3488 of 6976, read in place) at M = B; #1's merged QKV at
    # the verify's M = B·(k+1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    p = lp["ffn"]["w_gate"]
    rp = _draft_rank(p)
    spec_rows = []
    for stage, w, sk, sn in ((f"gate_up.1 eff_rank {rp}", p["qv"][:, :rp],
                              p["s2"], None),
                             (f"gate_up.2 eff_rank {rp}",
                              p["qu_t"][:rp // 32], None, p["s1"])):
        for dt, tdt in _dtypes():
            spec_rows.append(_check_packed(stage, w, sk, sn,
                                           QWEN["max_batch"], dt, tdt, gen))
    spec_rows += check_fused(lp, ("qkv",),
                             (QWEN["max_batch"] * (SPEC["spec_k"] + 1),), gen,
                             "qwen1.5-110b")
    report["spec_kernel_checks"] += spec_rows
    del lp
    free()
    return next(r for r in rows if r.get("stage") == "down.1"
                and (r["M"], r["dtype"]) == (8, "f32"))


def _check_packed(stage, w, sk, sn, m, dt, tdt, gen):
    import torch
    from repro_torch.kernels import binary_matmul, ref
    KW, N = w.shape
    K = KW * 32
    x = torch.randn((m, K), generator=gen, device="cuda").to(tdt)

    def kern():
        return binary_matmul.packed_matmul(x, w, sk, sn)

    def plain():
        return binary_matmul.packed_matmul_ref(x, w, sk, sn)
    abs_err, rel = compare(f"packed_matmul {stage} M={m} {dt}", plain(),
                           kern(), TOL[dt])
    W = ref.unpack_signs(w, tdt)          # the yardstick's pre-unpacked factor
    skt = None if sk is None else sk.to(tdt)
    snt = None if sn is None else sn.to(tdt)

    def library():
        y = torch.matmul(x if skt is None else x * skt, W)
        return y if snt is None else y * snt
    rec = _timed({"kernel": "packed_matmul", "model": "qwen1.5-110b",
                  "stage": stage, "M": m, "K": K, "N": N, "dtype": dt,
                  "max_abs_err": abs_err, "rel_err": rel,
                  "contiguous": w.is_contiguous()}, kern, plain, library)
    del W
    scale_bytes = 4 * (K if sk is not None else 0) + 4 * (N if sn is not None
                                                          else 0)
    io = nbytes(x) + m * N * x.element_size() + scale_bytes
    rec["bound_ms"], rec["bound_by"] = bound(
        4 * KW * N + io, (2.0 * m * K * N, BF16_TC_FLOPS_S))
    _tensor_core_row(rec, binary_matmul.packed_matmul.plan)
    log(f"kernel packed_matmul {stage:22s} M={m:<3d} {dt:4s} rel_err="
        f"{rel:.2e} ms={rec['ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"library_ms={rec['library_ms']:.4f} bound_ms={rec['bound_ms']:.5f} "
        f"({rec['bound_by']}; {100 * rec['bound_share']:.1f}% of it) "
        f"ks={rec['plan']['ks']}")
    return rec


def _tensor_core_row(rec, plan):
    """What a row of kernel #1 or #4 adds: the instruction its ±1 products
    run on, the launch plan of the timed call and the achieved share of
    the bound."""
    from repro_torch.kernels import binary_matmul
    rec.update(instruction=binary_matmul.INSTRUCTION, plan=dict(plan),
               bound_share=rec["bound_ms"] / rec["ms"])


def _dims(lp, name, eff_rank=None):
    """(rank, d_out) of layer ``lp``'s unmerged packed linear ``name``,
    the rank capped at ``eff_rank`` when a view reads fewer columns."""
    p = (lp["attn"] if name in lp["attn"] else lp["ffn"])[name]
    r = int(p["qv"].shape[-1])
    return min(r, eff_rank or r), int(p["qu_t"].shape[-1])


def _group(p):
    import torch
    return {"qv": p["qv"][None], "qu_t": p["qu_t"][None],
            "s1": p["s1"][None].float(), "s2": p["s2"][None].float(),
            "rmask": torch.ones((1, p["qv"].shape[-1]), device="cuda")}


def _paged_case(cfg, tdt, gen, B, pages, seed=SEED + 1, min_mapped=1):
    """B slots over a pool of 64-row pages, `pages` per slot: ragged
    tables (min_mapped..pages mapped), null-page padding, the last slot
    all-null. A case of another seed than the default draws its queries
    and activations from `gen` too; the default's come from torch's
    global generator, as they always have."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    PS = 64
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
        k = int(rng.integers(min_mapped, pages + 1))
        bt[b, :k] = perm[used:used + k]
        used += k
        pos[b] = int(rng.integers((k - 1) * PS, k * PS))
    return {"k_pool": kp, "v_pool": vp,
            "block_table": torch.from_numpy(bt).cuda(),
            "pos": torch.from_numpy(pos).cuda(), "valid_rows": int(
                (pos + 1).sum()), "B": B, "pages": pages,
            "gen": None if seed == SEED + 1 else gen}


def _walk_rate(dt):
    """The peak rate of the unit the page walk's arithmetic runs on: the
    tensor cores for a bf16 pool (at every shape these rows use: D 64 or
    128, 4 or 8 query heads per kv head, 64-row pages), the CUDA cores in
    f32."""
    return BF16_TC_FLOPS_S if dt == "bf16" else F32_FLOPS_S


def _randn(case, shape, dtype):
    import torch
    return torch.randn(shape, generator=case["gen"], device="cuda").to(dtype)


def _check_paged(case, cfg, dt, model_name):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention, ref
    B, hq, hkv, hd = case["B"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    q = _randn(case, (B, 1, hq, hd), kp.dtype)
    bt, pos = case["block_table"], case["pos"]
    scale = 1.0 / math.sqrt(hd)
    args = (q, kp, vp, bt, pos, pos)

    def kern():
        return paged_attention.paged_decode_attention(*args, scale=scale)

    def plain():
        return ref.paged_attention_ref(*args, scale=scale)
    abs_err, rel = compare(f"paged_attention {model_name} {dt}", plain(),
                           kern(), TOL[dt])
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
    rec = _timed({"kernel": "paged_decode_attention", "model": model_name,
                  "B": B, "pages": bt.shape[1], "D": hd, "G": hq // hkv,
                  "dtype": dt, "max_abs_err": abs_err, "rel_err": rel},
                 kern, plain, library)
    kv_bytes = case["valid_rows"] * hkv * hd * 2 * kp.element_size()
    b = kv_bytes + 2 * nbytes(q) + nbytes(bt) + 2 * nbytes(pos)
    rec["bound_ms"], rec["bound_by"] = bound(
        b, (4.0 * hq * hd * case["valid_rows"], _walk_rate(dt)))
    rec.update(plan=dict(paged_attention.paged_decode_attention.plan),
               bound_share=rec["bound_ms"] / rec["ms"])
    log(f"kernel paged_attention {model_name} B={B} pages={bt.shape[1]} "
        f"D={hd} G={hq // hkv} {dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} "
        f"plain_ms={rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({100 * rec['bound_share']:.1f}% of "
        f"it) splits={rec['plan']['splits']}")
    return rec


def _check_paged_verify(case, cfg, dt, S):
    """#2 as the speculative verify reads it: S queries per slot through
    ``ops.paged_attention`` (S launches at shifted positions) over the
    case's pool, whose rows past each slot's frontier hold stale values;
    each slot's first query is placed so that its S rows lie in its
    mapped pages, and query j sees the rows of queries 0..j."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ref
    B, hq, hkv, hd = case["B"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kp, vp, bt = case["k_pool"], case["v_pool"], case["block_table"]
    PS = kp.shape[1]
    room = ((bt != 0).sum(1) * PS - S).clamp(min=0)
    pos = torch.minimum(case["pos"].long(), room).to(torch.int32)
    q = _randn(case, (B, S, hq, hd), kp.dtype)
    scale = 1.0 / math.sqrt(hd)
    policy = kops.KernelPolicy(mode="cuda")

    def kern():
        return kops.paged_attention(q, kp, vp, bt, pos, pos, scale=scale,
                                    policy=policy)

    def plain():
        return ref.paged_attention_ref(q, kp, vp, bt, pos, pos, scale=scale)
    abs_err, rel = compare(f"paged_attention verify S={S} {dt}", plain(),
                           kern(), TOL[dt])
    # yardstick: SDPA over the pages gathered beforehand, each query's mask
    rows = bt.shape[1] * PS
    kg = kp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    vg = vp[bt.long()].reshape(B, rows, hkv, hd).transpose(1, 2)
    qpos = pos.long()[:, None] + torch.arange(S, device="cuda")
    mask = (torch.arange(rows, device="cuda")[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(qt, kg, vg, attn_mask=mask,
                                              scale=scale, enable_gqa=True)
    rec = _timed({"kernel": "paged_decode_attention", "model": "llama3.2-1b",
                  "B": B, "S": S, "pages": bt.shape[1], "D": hd,
                  "G": hq // hkv, "dtype": dt, "max_abs_err": abs_err,
                  "rel_err": rel}, kern, plain, library)
    p = pos.long().cpu()
    read_rows = int((p + S).sum())                    # rows 0..pos+S-1
    seen_rows = int(sum((p + j + 1).sum() for j in range(S)))
    b = (read_rows * hkv * hd * 2 * kp.element_size() + 2 * nbytes(q)
         + nbytes(bt) + 2 * nbytes(pos))
    rec["bound_ms"], rec["bound_by"] = bound(
        b, (4.0 * hq * hd * seen_rows, _walk_rate(dt)))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel paged_attention verify B={B} S={S} pages={bt.shape[1]} "
        f"{dt:4s} rel_err={rel:.2e} ms={rec['ms']:.4f} plain_ms="
        f"{rec['plain_ms']:.4f} library_ms={rec['library_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({100 * rec['bound_share']:.1f}% "
        f"of it; {S} launches)")
    return rec


def _check_mega(case, lp, cfg, dt, eff=None):
    """#3 at the case's shape; ``eff`` = (eff_rank, eff_rank_o) reads the
    draft view of the QKV group and of wo in place."""
    import torch
    from repro_torch.kernels import megakernel, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.models import layers
    B, hd = case["B"], cfg.head_dim
    kp, vp = case["k_pool"], case["v_pool"]
    x = _randn(case, (B, cfg.d_model), kp.dtype)
    mqkv, wo = lp["attn"]["wqkv"], lp["attn"]["wo"]
    bt, pos = case["block_table"], case["pos"]
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    kw = dict(dims=(nq, nkv), head_dim=hd, theta=cfg.rope_theta,
              scale=1.0 / math.sqrt(hd))
    if eff is not None:
        kw.update(eff_rank=eff[0], eff_rank_o=eff[1])
        mqkv, wo = {**mqkv, "eff_rank": eff[0]}, {**wo, "eff_rank": eff[1]}
    args = (x, mqkv, wo, kp, vp, bt, pos, pos)

    def kern():
        return megakernel.decode_step_megakernel_raw(*args, **kw)

    def plain():
        return ref.decode_step_ref(*args, **kw)

    def chain():
        """The unfused chain the kernel replaces, at the same inputs (the
        engine's pool writes of the fresh k/v left out, as they are from
        the kernel): #1 qkv, RoPE, #2, #1 wo."""
        q, k, _ = layers.dense_merged(mqkv, x[:, None], (nq, nkv, nkv))
        q = layers.apply_rope(q.reshape(B, 1, cfg.n_heads, hd), pos[:, None],
                              cfg.rope_theta)
        layers.apply_rope(k.reshape(B, 1, cfg.n_kv_heads, hd), pos[:, None],
                          cfg.rope_theta)
        o = kops.paged_attention(q, kp, vp, bt, pos, pos, scale=kw["scale"])
        return layers.dense(wo, o.reshape(B, 1, nq))
    got, want = kern(), plain()
    errs = [compare(f"megakernel pages={bt.shape[1]} eff_rank={eff} {nm} "
                    f"{dt}", w, g, TOL[dt])
            for nm, w, g in zip(("y", "k_new", "v_new"), want, got)]
    abs_err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    rec = _timed({"kernel": "decode_step_megakernel_raw",
                  "model": "llama3.2-1b", "B": B, "pages": bt.shape[1],
                  "dtype": dt, "max_abs_err": abs_err, "rel_err": rel,
                  **({} if eff is None else {"eff_rank": list(eff)})},
                 kern, plain, None)
    rec["plan"] = dict(megakernel.decode_step_megakernel_raw.plan)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    rec["cold_l2_ms"] = time_ms(kern, flush=flush)
    rec["chain_ms"] = time_ms(chain)
    del flush
    K, Ko = mqkv["qv"].shape[1] * 32, wo["qv"].shape[0] * 32
    e_qkv, e_o = eff if eff is not None else (None, None)
    qkv_bytes, qkv_flops = lowrank_cost(
        K, [_dims(lp, nm, e_qkv) for nm in ("wq", "wk", "wv")], B)
    wo_bytes, wo_flops = lowrank_cost(Ko, [_dims(lp, "wo", e_o)], B)
    kv_bytes = case["valid_rows"] * nkv * 2 * kp.element_size()
    io = (nbytes(x, bt, pos) + B * cfg.d_model * x.element_size()
          + B * 2 * nkv * kp.element_size())
    rec["bound_ms"], rec["bound_by"] = bound(
        qkv_bytes + wo_bytes + kv_bytes + io,
        (qkv_flops + wo_flops, BF16_TC_FLOPS_S),
        (4.0 * cfg.n_heads * hd * case["valid_rows"], _walk_rate(dt)))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"kernel megakernel B={B} pages={bt.shape[1]} "
        f"{'' if eff is None else f'eff_rank={eff} '}{dt:4s} rel_err="
        f"{rel:.2e} ms={rec['ms']:.4f} cold_l2_ms={rec['cold_l2_ms']:.4f} "
        f"chain_ms={rec['chain_ms']:.4f} plain_ms={rec['plain_ms']:.4f} "
        f"bound_ms={rec['bound_ms']:.5f} ({rec['bound_by']}; "
        f"{100 * rec['bound_share']:.1f}% of it) grid={rec['plan']['grid']} "
        f"walk splits={rec['plan']['walk']['splits']}")
    return rec


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _requests(cfg, traffic):
    import numpy as np
    rng = np.random.default_rng(SEED + 2)
    lens = rng.integers(*traffic["lens"], size=traffic["n"])
    return [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int64)
            for n in lens]


def _engine(model, traffic, policy, megakernel=None, spec=None):
    from repro_torch.serve.engine import ServeConfig
    return model.engine(ServeConfig(greedy=True, page_size=64,
                                    megakernel=megakernel, debug=True),
                        max_batch=traffic["max_batch"],
                        max_len=traffic["max_len"], policy=policy,
                        **(spec or {}))


def _submit(eng, prompts, uids, traffic):
    from repro_torch.serve.scheduler import Request
    for uid in uids:
        eng.submit(Request(uid, prompts[uid], max_new_tokens=traffic["new"]))


def serve(model, traffic, policy, megakernel=None, spec=None):
    """The traffic's requests: `up_front` submitted at once, the rest
    after `after` engine steps (mid-flight admission); speculative with
    `spec` (ServeConfig fields). Returns (outputs, engine, wall seconds)."""
    eng = _engine(model, traffic, policy, megakernel, spec)
    prompts = _requests(model.cfg, traffic)
    n, k = traffic["n"], traffic["up_front"]
    t0 = time.perf_counter()
    _submit(eng, prompts, range(k), traffic)
    for _ in range(traffic["after"]):
        eng.step()
    _submit(eng, prompts, range(k, n), traffic)
    done = eng.run()
    wall = time.perf_counter() - t0
    if sorted(done) != list(range(n)) or eng.kv.used_pages != 0 \
            or eng.kv.tables["linear"].any():
        raise AssertionError("engine did not finish every request cleanly")
    for uid, r in done.items():
        if len(r.output) != traffic["new"]:
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


def gate(model, traffic, name, got, want):
    """Identical greedy tokens, or a first divergence at a near-tie of
    the plain path (top-2 margin below the logits tolerance)."""
    prompts = _requests(model.cfg, traffic)
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


def _counters():
    from repro_torch.kernels import binary_matmul, megakernel, paged_attention
    return (binary_matmul.fused_lowrank_matmul_grouped,
            paged_attention.paged_decode_attention,
            megakernel.decode_step_megakernel_raw,
            binary_matmul.packed_matmul)


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def serve_paths(model, traffic, launches):
    """The f32 engine on the plain oracles, then each serving path of the
    traffic with every launch count set to 0 just before its run; each
    path's tokens are gated against the plain engine's (a speculative
    path's against its plain kernel path's) and its launches checked."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    arch = traffic["arch"]
    torch.cuda.reset_peak_memory_stats()
    want, eng, ref_wall = serve(model, traffic, KernelPolicy(mode="ref"))
    del eng
    free()
    res = {"ref_wall_s": ref_wall, "ref_peak_gib": _peak_gib()}
    log(f"engine {arch} f32 plain oracles: wall {ref_wall:.2f} s, peak "
        f"{res['ref_peak_gib']:.2f} GiB")
    counters = _counters()
    paths = [p for p in PATHS if p[1] is traffic]
    outs = {}
    for name, _, fields, mk, spec, versus, needed, forbidden in paths:
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        got, eng, wall = serve(model, traffic,
                               KernelPolicy(mode="cuda", **fields), mk, spec)
        launches[name] = [c.launches for c in counters]
        outs[name] = got
        st = dict(eng.stats)
        acceptance = eng.spec.acceptance_rate() if spec else None
        del eng
        free()
        log(f"engine path {name}: launches " + ", ".join(
            f"{k[0]}={n}" for k, n in zip(KERNELS, launches[name])))
        missing = [KERNELS[i][0] for i in needed if launches[name][i] == 0]
        if missing:
            raise AssertionError(f"engine path {name}: {missing} never "
                                 f"launched")
        stray = [KERNELS[i][0] for i in forbidden if launches[name][i]]
        if stray:
            raise AssertionError(f"engine path {name}: {stray} launched")
        margin = gate(model, traffic, name, got,
                      want if versus is None else outs[versus])
        res[name] = {"wall_s": wall, "max_divergence_margin": margin,
                     "stats": st, "peak_gib": _peak_gib()}
        if spec:
            # every drafted token is accepted or rolled back, and some
            # are rolled back, so that trim ran on the card
            if st["spec_draft_tokens"] != st["spec_accepted_tokens"] + \
                    st["spec_rollback_tokens"] or \
                    st["spec_rollback_tokens"] == 0:
                raise AssertionError(f"engine path {name}: spec counters "
                                     f"{st}")
            res[name]["acceptance_rate"] = acceptance
        log(f"engine {arch} f32 {name}: tokens match the "
            + ("plain" if versus is None else versus) + " path"
            + ("" if margin is None else " up to near-ties")
            + f"; {st['tokens_emitted']} tokens, {st['decode_steps']} decode "
            f"steps, {st['preemptions']} preemptions, wall {wall:.2f} s, "
            f"peak {res[name]['peak_gib']:.2f} GiB" + (
                "" if not spec else
                f"; acceptance {acceptance:.3f}, {st['spec_rollback_tokens']} "
                f"tokens and {st['spec_rollback_pages']} pages rolled back"))
    res["launches_by_path"] = {p[0]: launches[p[0]] for p in paths}
    return res


def bf16_run(model, traffic, report, spec=None):
    """The bf16 engine on the kernel path (speculative with `spec`):
    decode tok/s (tokens emitted by decode steps over their host wall
    time), host ms per step (per cycle when speculative), TTFT and peak
    memory; with `spec` also the acceptance rate and the tokens committed
    per slot and cycle (a + 1 on average)."""
    import torch
    from repro_torch.kernels.ops import KernelPolicy
    torch.cuda.reset_peak_memory_stats()
    _, eng, wall = serve(model, traffic, KernelPolicy(mode="cuda"), spec=spec)
    st = dict(eng.stats)
    ttft = sorted(h.ttft for h in eng.handles.values())
    acceptance = eng.spec.acceptance_rate() if spec else None
    del eng
    free()
    decode_tokens = st["tokens_emitted"] - st["admissions"]
    res = {"wall_s": wall, "decode_tok_s": decode_tokens
           / st["decode_time_s"], "ttft_s": ttft, "stats": st,
           "peak_gib": _peak_gib(),
           "decode_step_ms": 1e3 * st["decode_time_s"] / st["decode_steps"]}
    what = "step"
    if spec:
        slot_cycles = st["decode_steps"] * traffic["max_batch"] \
            - st["wasted_slot_steps"]
        res.update(acceptance_rate=acceptance,
                   committed_per_slot_cycle=decode_tokens / slot_cycles)
        what = (f"cycle; {res['committed_per_slot_cycle']:.2f} tokens "
                f"committed per slot and cycle, acceptance {acceptance:.3f}")
    log(f"engine {traffic['arch']} bf16{' spec' if spec else ''} on "
        f"{report['device']}: decode {res['decode_tok_s']:.1f} tok/s "
        f"({res['decode_step_ms']:.1f} ms per {what}; "
        f"{traffic['max_batch']} slots), TTFT median "
        f"{ttft[len(ttft) // 2] * 1e3:.1f} ms (max {ttft[-1] * 1e3:.1f} ms), "
        f"peak {res['peak_gib']:.2f} GiB, wall {wall:.2f} s")
    return res


def spec_compare(model, traffic, report):
    """bf16 plain decoding against speculative decoding on the kernel path,
    in turns (plain, spec, plain, spec) in this one process, since host
    time per step moves ±30% between processes; then the decode window of
    each under the profiler: device ms per committed token by kernel."""
    runs = {"plain": [], "spec": []}
    for kind in ("plain", "spec", "plain", "spec"):
        runs[kind].append(bf16_run(model, traffic, report,
                                   SPEC if kind == "spec" else None))
    prof = {kind: profile_decode(
        model, traffic, [r["decode_step_ms"] for r in runs[kind]],
        SPEC if kind == "spec" else None) for kind in runs}
    return {"runs": runs, "decode_profile": prof}


# The profiles record device activity only: every number read from them is
# device time, and recording the host's ops as well made a profiled run of
# small ops about 11x slower on the H100's host.


def _device_events(prof):
    from torch.autograd import DeviceType
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)


def _device_kernels(prof):
    dev = _device_events(prof)
    busy_s = sum(e.self_device_time_total for e in dev) * 1e-6
    top = [{"kernel": e.key[:80], "calls": e.count,
            "device_ms": e.self_device_time_total * 1e-3} for e in dev[:10]]
    return busy_s, top


def _by_kernel(prof):
    """Device ms by kernel #1-#4, the lm head's matmul and every other
    (small) PyTorch op."""
    out = {KERNELS[i][0]: 0.0 for i in range(len(KERNELS))}
    out.update({"lm_head": 0.0, "small_ops": 0.0})
    for e in _device_events(prof):
        name = next((KERNELS[i][0] for i, k in TRACE_NAMES if k in e.key),
                    None)
        if name is None:
            name = "lm_head" if any(g in e.key.lower() for g in GEMM_NAMES) \
                else "small_ops"
        out[name] += e.self_device_time_total * 1e-3
    return out


def profile_engine(model, traffic, wall):
    """The bf16 engine run once more under torch.profiler: device time by
    kernel and the device's busy share of the unprofiled run's wall time
    (one stream, so kernel times add up without overlap)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve(model, traffic, KernelPolicy(mode="cuda"))
        torch.cuda.synchronize()
    busy_s, top = _device_kernels(prof)
    if busy_s == 0:
        log("engine bf16 profile: device time not measured (the profiler "
            "recorded no device events)")
        return None
    log(f"engine {traffic['arch']} bf16 profile: device busy {busy_s:.3f} s "
        f"of the {wall:.3f} s unprofiled wall ({100 * busy_s / wall:.1f}%); "
        "top: " + "; ".join(f"{t['kernel'][:40]} x{t['calls']} "
                            f"{t['device_ms']:.1f} ms" for t in top[:5]))
    return {"device_busy_s": busy_s, "wall_s": wall, "top": top}


def profile_decode(model, traffic, host_ms, spec=None):
    """The bf16 engine again (speculative with `spec`), admitting every
    request unprofiled and then profiling the decode-only steps that
    follow: device time per decode step (per cycle when speculative) and
    per committed token, by kernel, beside ``host_ms``, the unprofiled
    runs' host ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ops import KernelPolicy
    eng = _engine(model, traffic, KernelPolicy(mode="cuda"), spec=spec)
    prompts = _requests(model.cfg, traffic)
    _submit(eng, prompts, range(traffic["n"]), traffic)
    while eng.scheduler.pending:
        eng.step()
    eng.step()                       # the first step with every slot filled
    torch.cuda.synchronize()
    steps0, tokens0 = eng.stats["decode_steps"], eng.stats["tokens_emitted"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        while eng.in_flight:
            if eng.scheduler.pending:
                raise AssertionError("an admission fell in the decode window")
            eng.step()
        torch.cuda.synchronize()
    steps = eng.stats["decode_steps"] - steps0
    tokens = eng.stats["tokens_emitted"] - tokens0
    acceptance = eng.spec.acceptance_rate() if spec else None
    del eng
    free()
    busy_s, top = _device_kernels(prof)
    kind = "spec" if spec else "plain"
    if busy_s == 0 or steps == 0:
        log(f"engine bf16 {kind} decode profile: device time not measured")
        return None
    per_step = 1e3 * busy_s / steps
    by_kernel = {k: v / tokens for k, v in _by_kernel(prof).items()}
    log(f"engine {traffic['arch']} bf16 {kind} decode profile: {steps} "
        f"{'cycles' if spec else 'steps'}, {tokens} tokens committed, device "
        f"busy {per_step:.2f} ms per {'cycle' if spec else 'step'} against "
        f"{', '.join(f'{h:.2f}' for h in host_ms)} ms of host time "
        f"unprofiled; {1e3 * busy_s / tokens:.3f} device ms per committed "
        f"token: " + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items()
                               if v))
    return {"decode_steps": steps, "committed_tokens": tokens,
            "device_ms_per_step": per_step,
            "device_ms_per_token": 1e3 * busy_s / tokens,
            "by_kernel_ms_per_token": by_kernel, "host_ms_per_step": host_ms,
            "acceptance_rate": acceptance,
            "top_per_step": [dict(t, calls=t["calls"] / steps,
                                  device_ms=t["device_ms"] / steps)
                             for t in top]}


if __name__ == "__main__":
    main()
