"""The rank side of ``tests/test_torch_sharding.py``,
``tests/test_torch_tp_families.py`` and ``tests/test_torch_tp_state.py``:
functions that each rank of a gloo group runs on the CPU
(``repro_torch.launch.mesh.run_ranks``). It imports torch, numpy and
``repro_torch`` only, so a spawned rank starts without JAX; everything a
rank needs (numpy param trees, prompts) comes in its arguments, and
everything the checks need comes back in its one picklable result."""
import numpy as np
import torch

from repro_torch.api import NanoQuantModel
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import binary_matmul, ops
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.quant.surgery import merge_projection_groups, place_on_mesh
from repro_torch.serve.engine import InferenceEngine, ServeConfig
from repro_torch.serve.scheduler import Request
from repro_torch.sharding import comm

TP = 2
# the reference's own TP config (tests/test_engine.py's sharded engine)
TP_CFG = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                     n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                     loss_chunk=0, remat=False, dtype="float32")


def serve(eng, prompts, budgets):
    """Every prompt submitted, the first two up front and the rest after
    one step (mid-flight admission), then drained: (tokens, stats)."""
    for uid, (p, b) in enumerate(zip(prompts, budgets)):
        eng.submit(Request(uid, np.asarray(p, np.int64), max_new_tokens=b))
        if uid == 1:
            eng.step()
    done = eng.run()
    return {u: r.output.tolist() for u, r in done.items()}, dict(eng.stats)


def _drained(eng) -> bool:
    kv = eng.kv
    if kv is None:                  # the rectangle: no pages to account
        return not eng.active.any() and not eng.scheduler.pending
    ok = not kv.ref.any() and kv.used_pages == kv.cached_page_count \
        and not any(t.any() for t in kv.tables.values())
    if eng.prefix is not None:
        eng.prefix.clear()
    return ok and kv.used_pages == 0


def _engine_run(tree, cfg, mesh, prompts, budgets, policy, **scfg):
    eng = InferenceEngine(params_from_numpy(tree, "cpu"), cfg,
                          ServeConfig(greedy=True, page_size=8, debug=True,
                                      **scfg),
                          max_batch=2, max_len=48, device="cpu",
                          policy=policy, mesh=mesh)
    toks, stats = serve(eng, prompts, budgets)
    pool = tuple(eng.cache["layers"]["k"].shape)
    return {"tokens": toks, "stats": stats, "pool": pool,
            "kv_bytes": eng.kv_cache_bytes(), "drained": _drained(eng)}


def _gather_heads(o, mesh):
    """(B, S, H_local, D) of every rank -> (B, S, H, D), in rank order."""
    B, S, H, D = o.shape
    return comm.all_gather_last(o.reshape(B, S, H * D), mesh).reshape(
        B, S, -1, D)


def _launches(lin, x, mesh, pol):
    """Column, row and merged launches on this rank's shards of `lin` (a
    layer's packed wq / wo / w_gate / w_up), gathered or summed to full
    outputs."""
    n, r = mesh.tp, mesh.tp_rank
    col = ops.lowrank_binary_matmul(x, *_ops(lin["wq"]), policy=pol,
                                    tp="col")
    k_loc = lin["wo"]["qv"].shape[0] * 32
    row = ops.lowrank_binary_matmul(x[:, r * k_loc:(r + 1) * k_loc],
                                    *_ops(lin["wo"]), policy=pol, tp="row")
    merged = merge_projection_groups({"ffn": lin})["ffn"]["wgu"]
    d = lin["w_gate"]["qu_t"].shape[-1]
    g, u = ops.lowrank_binary_matmul_merged(x, merged, (d, d), policy=pol)
    return {"col": comm.all_gather_last(col, mesh), "row": row,
            "gate": comm.all_gather_last(g, mesh),
            "up": comm.all_gather_last(u, mesh), "n": n}


def _ops(p):
    return p["qv"], p["qu_t"], p["s1"], p["s2"]


def rank_checks(rank, case):
    """Everything the parent's tests read, from one rank: the launches
    (fused and, with MAX_FUSED_RANK lowered, the two-call route), the
    head-local paged attention, the engines and the lockstep check."""
    torch.manual_seed(0)
    mesh = make_serving_mesh(TP, device="cpu")
    out = {"rank": rank, "coords": dict(mesh.coords),
           "broadcast": comm.broadcast_object({"from": rank}, mesh)}

    # ---- the launches --------------------------------------------------
    lin = place_on_mesh(params_from_numpy(case["linears"], "cpu"),
                        case["lin_cfg"], mesh)["layers"]
    x = torch.from_numpy(case["x"])
    pol = ops.KernelPolicy(mode="cuda", mesh=mesh)
    out["fused"] = {k: v.numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in _launches(lin, x, mesh, pol).items()}
    keep = binary_matmul.MAX_FUSED_RANK
    binary_matmul.MAX_FUSED_RANK = 16
    try:
        out["twocall"] = {k: v.numpy() if isinstance(v, torch.Tensor)
                          else v for k, v in
                          _launches(lin, x, mesh, pol).items()}
    finally:
        binary_matmul.MAX_FUSED_RANK = keep

    # ---- head-local paged attention ------------------------------------
    pa = {k: torch.from_numpy(v) for k, v in case["paged"].items()}
    hq = pa["q"].shape[2] // TP
    hkv = pa["k"].shape[2] // TP
    o = ops.paged_attention(
        pa["q"][:, :, rank * hq:(rank + 1) * hq].contiguous(),
        pa["k"][:, :, rank * hkv:(rank + 1) * hkv].contiguous(),
        pa["v"][:, :, rank * hkv:(rank + 1) * hkv].contiguous(),
        pa["bt"], pa["q_pos"], pa["q_pos"], scale=0.25, policy=pol)
    out["paged"] = _gather_heads(o, mesh).numpy()

    # ---- engines -------------------------------------------------------
    comm.reset_stats()
    cuda = ops.KernelPolicy(mode="cuda")
    out["plain"] = _engine_run(case["tiny"], TP_CFG, mesh, case["prompts"],
                               case["budgets"], ops.KernelPolicy(mode="ref"),
                               prefix_cache=False)
    out["plain"]["comm"] = dict(comm.STATS)
    out["prefix"] = _engine_run(case["tiny"], TP_CFG, mesh, case["prompts"],
                                case["budgets"], cuda)
    # the draft's near-ties follow the policy's rounding: the spec
    # counters are held to JAX's under the policy JAX's CPU engine runs
    out["spec"] = _engine_run(case["tiny"], TP_CFG, mesh, case["prompts"],
                              case["budgets"], ops.KernelPolicy(mode="ref"),
                              spec_rank_frac=0.5, spec_k=2)
    out["rect"] = _engine_run(case["tiny"], TP_CFG, mesh, case["prompts"],
                              case["budgets"], cuda, paged=False)
    binary_matmul.MAX_FUSED_RANK = 64
    try:
        for name, paged in (("qwen", True), ("qwen_rect", False)):
            out[name] = _engine_run(case["qwen"], case["qwen_cfg"], mesh,
                                    case["qwen_prompts"],
                                    case["budgets"][:4], cuda, paged=paged)
    finally:
        binary_matmul.MAX_FUSED_RANK = keep

    # ---- launch.serve --rect --tp 2: the CLI's serving loop on this rank's
    # shards, and on the whole model without a mesh (its seeded sampler
    # draws the same numbers on both)
    args = cli._parser().parse_args(case["cli_argv"])
    for name, m in (("cli_rect", mesh), ("cli_rect_unsharded", None)):
        model = NanoQuantModel.from_numpy(case["tiny"], TP_CFG, device="cpu")
        out[name] = {u: t.tolist()
                     for u, t in cli._serve(args, model, m).items()}

    # ---- lockstep: one rank queues what the other does not (host state
    # only: a step would launch collectives the other rank never joins)
    eng = InferenceEngine(params_from_numpy(case["tiny"], "cpu"), TP_CFG,
                          ServeConfig(greedy=True, page_size=8),
                          max_batch=2, max_len=48, device="cpu", mesh=mesh)
    eng.check_invariants()
    if rank == 1:
        eng.submit(Request(9, np.arange(1, 5), max_new_tokens=2))
    try:
        eng.check_invariants()
        out["lockstep"] = None
    except RuntimeError as e:
        out["lockstep"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the audio and MoE families (tests/test_torch_tp_families.py)
# ---------------------------------------------------------------------------


class _Spies:
    """While open: every router call's chosen experts, every call of #1's
    wrapper as (groups, x per group), and the calls of #2's and #4's
    wrappers."""

    def __enter__(self):
        from repro_torch.kernels import paged_attention
        from repro_torch.models import layers
        self.routes, self.grids = [], []
        self.paged = self.packed = 0
        route = layers._route
        grouped = binary_matmul.fused_lowrank_matmul_grouped
        paged = paged_attention.paged_decode_attention
        packed = binary_matmul.packed_matmul
        self._real = (route, grouped, paged, packed)

        def spy_route(p, cfg, xf):
            out = route(p, cfg, xf)
            self.routes.append(out[1].numpy().copy())
            return out

        def spy_grouped(x, qv, *a, **kw):
            self.grids.append((int(qv.shape[0]), bool(kw.get("x_shared"))))
            return grouped(x, qv, *a, **kw)

        def spy_paged(*a, **kw):
            self.paged += 1
            return paged(*a, **kw)

        def spy_packed(*a, **kw):
            self.packed += 1
            return packed(*a, **kw)
        layers._route = spy_route
        binary_matmul.fused_lowrank_matmul_grouped = spy_grouped
        paged_attention.paged_decode_attention = spy_paged
        binary_matmul.packed_matmul = spy_packed
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import paged_attention
        from repro_torch.models import layers
        (layers._route, binary_matmul.fused_lowrank_matmul_grouped,
         paged_attention.paged_decode_attention,
         binary_matmul.packed_matmul) = self._real


def _family_run(tree, cfg, mesh, prompts, budgets, policy, **scfg):
    """One engine run of a family's model over this rank's shards: tokens,
    stats, collectives, the cache's leaf shapes, the routers' choices and
    #1's calls by grid."""
    eng = InferenceEngine(params_from_numpy(tree, "cpu"), cfg,
                          ServeConfig(greedy=True, page_size=8, debug=True,
                                      **scfg),
                          max_batch=2, max_len=48, device="cpu",
                          policy=policy, mesh=mesh)
    comm.reset_stats()
    with _Spies() as spies:
        toks, stats = serve(eng, prompts, budgets)
    cache = {stack: {k: tuple(v.shape) for k, v in leaves.items()}
             for stack, leaves in eng.cache.items()}
    return {"tokens": toks, "stats": stats, "comm": dict(comm.STATS),
            "cache": cache, "kv_bytes": eng.kv_cache_bytes(),
            "drained": _drained(eng), "routes": spies.routes,
            "grids": spies.grids, "paged": spies.paged,
            "packed": spies.packed}


def _expert_launches(case, mesh):
    """#1's expert launch on this rank's block of the stack, placed by
    ``place_on_mesh`` (the qwen3-moe smoke config's rules), x the
    matching slice of the dispatch buffer: fused, two-call and ref."""
    from repro_torch.models import layers
    cfg = case["qwen_cfg"]
    stack = place_on_mesh(params_from_numpy(case["experts"], "cpu"), cfg,
                          mesh)["layers"]["moe"]["w_gate"]
    lin = {k: v[0] for k, v in stack.items()}
    with ops.kernel_policy(ops.KernelPolicy(mesh=mesh)):
        lo, held = layers._expert_range({"w_gate": lin}, cfg)
    xs = torch.from_numpy(case["expert_x"])[lo:lo + held]
    out = {"range": (lo, held)}
    for name, pol in (("fused", ops.KernelPolicy(mode="cuda", mesh=mesh)),
                      ("ref", ops.KernelPolicy(mode="ref", mesh=mesh))):
        out[name] = ops.lowrank_binary_matmul_expert(
            xs, *_ops(lin), policy=pol).numpy()
    keep = binary_matmul.MAX_FUSED_RANK
    binary_matmul.MAX_FUSED_RANK = 16
    try:
        out["twocall"] = ops.lowrank_binary_matmul_expert(
            xs, *_ops(lin), policy=ops.KernelPolicy(mode="cuda",
                                                   mesh=mesh)).numpy()
    finally:
        binary_matmul.MAX_FUSED_RANK = keep
    return out


def family_checks(rank, case):
    """Everything ``tests/test_torch_tp_families.py`` reads, from one rank:
    the rank-local expert launch, the audio family's vocab-parallel
    embedding, and the engines of qwen3-moe (paged, rectangle, prefix,
    speculative), deepseek (MLA; paged and rectangle) and musicgen (paged
    and rectangle) over this rank's shards."""
    from repro_torch.kernels.ops import kernel_policy
    from repro_torch.models import transformer as T
    torch.manual_seed(0)
    mesh = make_serving_mesh(TP, device="cpu")
    out = {"rank": rank, "experts": _expert_launches(case, mesh)}

    # the audio family's embedding, sharded and whole
    mcfg = case["musicgen_cfg"]
    full = params_from_numpy(case["musicgen"], "cpu")
    local = place_on_mesh(full, mcfg, mesh)
    frames = torch.from_numpy(case["frames"]).long()
    with kernel_policy(ops.KernelPolicy(mode="cuda", mesh=mesh)):
        out["embed"] = (T.embed_tokens(local, mcfg, frames).numpy(),
                        T.embed_tokens(full, mcfg, frames).numpy(),
                        tuple(local["embed"].shape))

    cuda, ref = ops.KernelPolicy(mode="cuda"), ops.KernelPolicy(mode="ref")
    for name, paged in (("paged", True), ("rect", False)):
        for arch in ("qwen", "deepseek", "musicgen"):
            out[f"{arch}_{name}"] = _family_run(
                case[arch], case[f"{arch}_cfg"], mesh,
                case[f"{arch}_prompts"], case["budgets"], cuda,
                paged=paged, prefix_cache=False)
    out["qwen_prefix"] = _family_run(
        case["qwen"], case["qwen_cfg"], mesh, case["shared_prompts"],
        case["shared_budgets"], cuda)
    # the draft's near-ties follow the policy's rounding: the spec
    # counters are held to JAX's under the policy JAX's CPU engine runs
    out["qwen_spec"] = _family_run(
        case["qwen_spec"], case["qwen_cfg"], mesh, case["qwen_prompts"],
        case["budgets"], ref, prefix_cache=False, spec_rank_frac=0.5,
        spec_k=4)
    return out


# ---------------------------------------------------------------------------
# the SSM, hybrid and VLM families (tests/test_torch_tp_state.py)
# ---------------------------------------------------------------------------


def _mixer_run(case, key, mesh):
    """One Mamba2 mixer (layer 0 of `key`'s model) on this rank's shards:
    the full sequence and one recurrent step from a seeded state cut to
    the rank's SSD heads / d_inner columns; the output (whole, after the
    all-reduce) and the new state's shards. Then the same full sequence
    with the gated norm taken over the rank's own columns only, a rank
    that skips the norm's all-reduce."""
    from repro_torch.models import layers
    cfg = case[f"{key}_cfg"]
    H = cfg.ssm_heads // mesh.tp
    heads = slice(mesh.tp_rank * H, (mesh.tp_rank + 1) * H)
    mixer = params_from_numpy(case[f"{key}_mixer"], "cpu")
    local = place_on_mesh({"layers": {"mixer": mixer}}, cfg,
                          mesh)["layers"]["mixer"]
    cols = slice(heads.start * cfg.ssm_head_dim,
                 heads.stop * cfg.ssm_head_dim)
    st = {k: torch.from_numpy(v) for k, v in case["mixer_state"].items()}
    st["ssm"], st["conv_x"] = st["ssm"][:, heads], st["conv_x"][..., cols]
    out = {}
    with ops.kernel_policy(ops.KernelPolicy(mode="cuda", mesh=mesh)):
        for route, x, state in (("full", case["mixer_x"], None),
                                ("step", case["mixer_x1"], st)):
            y, new = layers.mamba2(local, cfg, torch.from_numpy(x), state)
            out[route] = (y.numpy(), {k: v.numpy() for k, v in new.items()})
        real = layers._gated_norm
        layers._gated_norm = lambda y, w, eps, width, sharded: real(
            y, w, eps, y.shape[-1], False)
        try:
            out["own_norm"] = layers.mamba2(
                local, cfg, torch.from_numpy(case["mixer_x"]))[0].numpy()
        finally:
            layers._gated_norm = real
    return out


def state_checks(rank, case):
    """Everything ``tests/test_torch_tp_state.py`` reads, from one rank:
    a Mamba2 mixer of mamba2's and of zamba2's on the rank's SSD heads,
    the VLM's forward with an image over the rank's shards (the smoke
    config, and a variant with one kv head, whose image K/V every rank
    holds whole), and the engines of the three smoke configs, on the
    pool (or the SSM's state cache) and on the rectangle."""
    from repro_torch.models import transformer as T
    torch.manual_seed(0)
    mesh = make_serving_mesh(TP, device="cpu")
    out = {"rank": rank, "mixer": {k: _mixer_run(case, k, mesh)
                                   for k in ("mamba", "zamba")}}
    pol = ops.KernelPolicy(mode="cuda", mesh=mesh)
    for key in ("vision", "vision_kv1"):
        cfg = case[f"{key}_cfg"]
        local = place_on_mesh(params_from_numpy(case[key], "cpu"), cfg, mesh)
        with ops.kernel_policy(pol), torch.inference_mode():
            out[f"{key}_forward"] = T.forward(
                local, cfg, torch.from_numpy(case["image_tokens"]).long(),
                torch.from_numpy(case["image"])).numpy()
        out[f"{key}_wk"] = tuple(local["cross_layers"]["xattn"]["wk"]
                                 ["qu_t"].shape)
    cuda = ops.KernelPolicy(mode="cuda")
    for name, paged in (("paged", True), ("rect", False)):
        for key in ("mamba", "zamba", "vision"):
            out[f"{key}_{name}"] = _family_run(
                case[key], case[f"{key}_cfg"], mesh, case["prompts"][key],
                case["budgets"], cuda, paged=paged, prefix_cache=False)
    # zamba2's shared block over rings that wrap (window 16)
    out["zamba_wrap"] = _family_run(
        case["zamba"], case["zamba_wrap_cfg"], mesh, case["prompts"]["wrap"],
        case["wrap_budgets"], cuda, prefix_cache=False)
    return out
