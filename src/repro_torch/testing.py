"""Packed parameter trees drawn from a seed, and the chaos traffic and
fault schedule, for the tests and ``chip_smoke.py``: the repo holds no
weights, so a model of a published shape is built from
:func:`repro_torch.quant.surgery.abstract_quantized_params` filled with
random words and scales. Neither the engine nor the CLIs use this
module.

Both fillers draw from the same distributions, scaled so activations
stay O(1) through any depth: packed words uniform; s2 ≈ 1/√K and s1 ≈
1/√R times N(1, 0.1) (per expert for stacked experts); the embedding
N(0, 0.02); norms N(1, 0.1); FP weights, the MoE router (f32) among
them, N(0, 1/d_in); biases N(0, 0.02). The VLM's scalar cross-attention
and FFN gates are N(1, 0.1) (:data:`GATE_LAWS`), so that tanh(gate) ≈
0.76 and every cross block does real work (the JAX package initialises
them to 0, which makes each cross block the identity). The Mamba2
mixer's leaves follow
``repro.models.layers.init_mamba2``: conv kernels N(0, 0.2), conv biases
N(0, 0.02), D N(1, 0.1), A_log uniform in [0, log 16] (decay rates 1 to
16) and dt_bias uniform in [log 1e-3, log 1e-1]. :func:`random_packed_params`
draws on the host with numpy (the CPU parity tests hand its arrays to
both packages); :func:`random_packed_params_device` draws on the card, one
leaf at a time, for full-size models whose host draw would take tens of
GB and minutes. The two give different numbers from one seed.
:func:`chaos_trace`, :func:`chaos_plan` and :func:`drive_chaos` are the
JAX package's chaos benchmark (``benchmarks/serve_bench.py``) for either
package's engine; :func:`image_embeds` and :func:`image_embeds_device`
the VLM's stubbed patch embeddings under the JAX package's law
(``repro.data.synthetic``: standard normal); :func:`with_gates` redraws
an FP VLM teacher's zero gates under :data:`GATE_LAWS`, so that quantizing
it exercises the cross blocks."""
import numpy as np
import torch

# (low, high) of the leaves drawn uniformly: the Mamba2 mixer's A_log and
# dt_bias (init_mamba2 spaces A over [1, 16] and draws dt in [1e-3, 1e-1])
UNIFORM_LAWS = {"A_log": (0.0, float(np.log(16.0))),
                "dt_bias": (float(np.log(1e-3)), float(np.log(1e-1)))}


# (mean, std) of the VLM's scalar gates: tanh(1) ≈ 0.76, away from 0
GATE_LAWS = {"gate": (1.0, 0.1), "ffn_gate": (1.0, 0.1)}


def _normal_law(name, shape, packed):
    """(mean, std) of a floating leaf not in :data:`UNIFORM_LAWS`: the leaf
    is mean + std · N(0, 1)."""
    if name in GATE_LAWS:
        return GATE_LAWS[name]
    if packed and name == "s2":
        mean = 1.0 / np.sqrt(shape[-1])
        return mean, 0.1 * mean
    if packed and name == "s1":
        mean = 1.0 / np.sqrt(32 * packed["qu_t"].shape[-2])
        return mean, 0.1 * mean
    if name in ("embed", "b") or name.startswith("conv_b"):
        return 0.0, 0.02
    if name.startswith("conv_"):                # Mamba2's depthwise kernels
        return 0.0, 0.2
    if name == "w":
        return 0.0, 1.0 / np.sqrt(shape[-2])
    return 1.0, 0.1                             # norm weights


def _walk(tree, fill, packed=None):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out[k] = _walk(v, fill, v if "qu_t" in v else None)
        else:
            out[k] = fill(k, tuple(v.shape), v.dtype, packed)
    return out


def random_packed_params(template, seed: int):
    """Fill a template (:func:`abstract_quantized_params` /
    :func:`param_specs`) with numpy arrays from
    ``numpy.random.default_rng(seed)``. Floating leaves come back as
    float32 (cast them with ``convert.params_from_numpy(dtype=)``);
    packed words as uint32."""
    rng = np.random.default_rng(seed)

    def fill(name, shape, dtype, packed):
        if dtype == "uint32":
            return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint32)
        if name in UNIFORM_LAWS:
            return rng.uniform(*UNIFORM_LAWS[name], size=shape
                               ).astype(np.float32)
        mean, std = _normal_law(name, shape, packed)
        return (mean + std * rng.standard_normal(shape)).astype(np.float32)

    return _walk(template, fill)


def random_packed_params_device(template, seed: int, device="cuda"):
    """Fill a template on `device` from a ``torch.Generator`` seeded with
    `seed`, one leaf at a time: packed words as int32 (the port's layout),
    floating leaves as float32 (cast a model's FP leaves with
    ``convert.params_from_numpy(tree, device, dtype)``, which also takes
    tensors and leaves the packed ones shared)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def fill(name, shape, dtype, packed):
        if dtype == "uint32":
            return torch.randint(-2 ** 31, 2 ** 31, shape, dtype=torch.int32,
                                 generator=gen, device=device)
        if name in UNIFORM_LAWS:
            lo, hi = UNIFORM_LAWS[name]
            return torch.rand(shape, generator=gen, device=device
                              ).mul_(hi - lo).add_(lo)
        mean, std = _normal_law(name, shape, packed)
        return torch.randn(shape, generator=gen, device=device
                           ).mul_(float(std)).add_(float(mean))

    return _walk(template, fill)


def with_gates(params, seed: int):
    """`params` (a VLM teacher: numpy arrays or tensors) with its cross
    blocks' ``xattn.gate`` and ``ffn_gate`` drawn under :data:`GATE_LAWS`
    from ``numpy.random.default_rng(seed)``, each in its leaf's type,
    dtype and device; every other leaf shared. The JAX package's teacher
    has them 0: each cross block the identity, its linears given zero
    output gradients and so identity preconditioners."""
    rng = np.random.default_rng(seed)
    cross = dict(params["cross_layers"])
    xattn = dict(cross["xattn"])

    def draw(name, leaf):
        mean, std = GATE_LAWS[name]
        val = (mean + std * rng.standard_normal(tuple(leaf.shape))
               ).astype(np.float32)
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(val).to(leaf.device, leaf.dtype)
        return val.astype(leaf.dtype)
    xattn["gate"] = draw("gate", xattn["gate"])
    cross["xattn"] = xattn
    cross["ffn_gate"] = draw("ffn_gate", cross["ffn_gate"])
    return dict(params, cross_layers=cross)


def image_embeds(cfg, batch: int, seed: int) -> np.ndarray:
    """Stubbed patch embeddings (batch, n_image_tokens, d_model), float32
    standard normal from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, cfg.n_image_tokens, cfg.d_model)
                               ).astype(np.float32)


def image_embeds_device(cfg, batch: int, seed: int, device="cuda",
                        dtype=torch.float32):
    """The same law drawn on `device` from a ``torch.Generator`` seeded
    with `seed` (other numbers than :func:`image_embeds`)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((batch, cfg.n_image_tokens, cfg.d_model),
                       generator=gen, device=device).to(dtype)


def chaos_trace(rng, n_req: int, vocab: int, max_prompt: int = 24,
                max_new: int = 16):
    """The JAX package's chaos traffic (``benchmarks/serve_bench.py``
    ``build_trace``): requests of 4..`max_prompt` prompt tokens and
    2..`max_new` new tokens with Poisson(0.6) arrival gaps in engine
    steps, drawn from `rng` in its order. Returns [(arrival step, uid,
    prompt int64, budget)]."""
    trace, step = [], 0
    for uid in range(n_req):
        step += int(rng.poisson(0.6))
        prompt = rng.integers(0, vocab,
                              size=(int(rng.integers(4, max_prompt + 1)),)
                              ).astype(np.int64)
        budget = int(rng.integers(2, max_new + 1))
        trace.append((step, uid, prompt, budget))
    return trace


def chaos_plan(trace, dry_pages: int = 3):
    """The JAX package's chaos schedule (``benchmarks/serve_bench.py``
    ``build_chaos_plan``) over `trace`: 11 faults covering every kind,
    each targeted so that it fires. Mid-flight kinds hit the requests of
    the largest budgets; queue-side kinds arm at step 0 and fire at the
    first tick after their target's arrival. `dry_pages` is the size of
    the dry-pool borrow (3 of the reference's 12-page pool)."""
    from repro_torch.serve.faults import Fault
    u = [t[1] for t in sorted(trace, key=lambda t: (-t[3], t[1]))[:8]]
    return [
        Fault(step=0, kind="cancel_spec", uid=u[0]),
        Fault(step=4, kind="device_error", uid=u[1]),
        Fault(step=0, kind="cancel_prefill", uid=u[2]),
        Fault(step=0, kind="poison_prefill", uid=u[3]),
        Fault(step=0, kind="expire", uid=u[4]),
        Fault(step=0, kind="expire", uid=u[5]),
        Fault(step=0, kind="expire", uid=u[6]),
        Fault(step=0, kind="cancel", uid=u[7]),
        Fault(step=2, kind="dry_pool", pages=dry_pages, hold=2),
        Fault(step=3, kind="evict_prefix", pages=2),
        Fault(step=3, kind="preempt", pages=2),
    ]


def drive_chaos(eng, trace, request, faults=None):
    """Submit `trace` by arrival step to `eng` (either package's engine,
    with its `request` type) and step it to quiescence, past the plan's
    dry-pool borrows; returns {uid: handle}."""
    handles, i = {}, 0
    while i < len(trace) or eng.in_flight \
            or (faults is not None and faults.borrowed_pages):
        while i < len(trace) and trace[i][0] <= eng.stats["steps"]:
            _, uid, prompt, budget = trace[i]
            handles[uid] = eng.submit(request(uid, prompt,
                                              max_new_tokens=budget))
            i += 1
        eng.step()
    return handles
