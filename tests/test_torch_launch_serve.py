"""``python -m repro_torch.launch.serve`` without an artifact, as the
reference CLI runs it: ``--arch``'s smoke teacher (``init_params`` from
seed 0, the config's bf16) quantized on ``calib_batches(cfg, 8, 64)``
under ``QuantConfig(admm_iters=10, t_pre=5, t_post=5, t_glob=5,
rank_align=32)``, or with ``--fp`` served as it is. For one arch of every
family the CLI's tokens (its seeded sampler, temperature 0.8, top-k 32)
equal those of the port's engine over a model built here through the
public entry points, ``NanoQuantModel.quantize`` or ``from_fp``, under
the same requests and settings.
"""
import numpy as np
import pytest
import torch

from _torch_common import one_torch_thread  # noqa: F401
from repro_torch.api import NanoQuantModel
from repro_torch.configs import get_smoke
from repro_torch.core.pipeline import QuantConfig
from repro_torch.data.synthetic import calib_batches
from repro_torch.launch import serve as cli
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeConfig
from repro_torch.serve.scheduler import Request

FAMILIES = {"dense": "llama3.2-1b", "moe": "qwen3-moe-235b-a22b",
            "mla": "deepseek-v2-lite-16b", "ssm": "mamba2-370m",
            "hybrid": "zamba2-1.2b", "vlm": "llama-3.2-vision-90b",
            "audio": "musicgen-medium"}
N, PROMPT, NEW, BATCH, PAGE = 3, 6, 4, 2, 4


def _expected(arch, fp, paged=True):
    """The engine's tokens over the demo model built from the public entry
    points, under the CLI's requests and serving settings (on the
    rectangle with ``paged=False``, as ``--rect`` serves)."""
    cfg = get_smoke(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if fp:
        model = NanoQuantModel.from_fp(params, cfg)
    else:
        qcfg = QuantConfig(admm_iters=10, t_pre=5, t_post=5, t_glob=5,
                           rank_align=32)
        model = NanoQuantModel.quantize(params, cfg, calib_batches(cfg, 8, 64),
                                        qcfg, verbose=False, device="cpu")
    eng = model.engine(ServeConfig(max_new_tokens=NEW, page_size=PAGE,
                                   paged=paged),
                       max_batch=BATCH, max_len=PROMPT + NEW)
    rng = np.random.default_rng(0)
    shape = (PROMPT, cfg.n_codebooks) if cfg.family == "audio" else (PROMPT,)
    for uid in range(N):
        eng.submit(Request(uid, rng.integers(0, cfg.vocab_size, size=shape)
                           .astype(np.int64), max_new_tokens=NEW))
    return {u: r.output for u, r in eng.run().items()}


@pytest.mark.parametrize("fp", [False, True], ids=["demo", "fp"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_serve_cli_demo_and_fp(family, fp, capsys):
    """The CLI without ``--quantized-ckpt`` prints the reference's demo
    line (with ``--fp``, the FP teacher's) and emits the tokens of the
    engine over ``NanoQuantModel.quantize`` (``from_fp``) with the same
    settings."""
    arch = FAMILIES[family]
    got = cli.main(["--device", "cpu", "--arch", arch, "--requests", str(N),
                    "--prompt-len", str(PROMPT), "--max-new", str(NEW),
                    "--max-batch", str(BATCH), "--page-size", str(PAGE)]
                   + (["--fp"] if fp else []))
    out = capsys.readouterr().out
    line = ("[serve] FP random-init teacher (--fp)" if fp else
            "[serve] quantized random-init teacher (demo)")
    assert line in out
    assert f"{get_smoke(arch).name} (bfloat16) teacher from seed 0" in out
    assert f"{N} requests, {N * NEW} tokens" in out
    want = _expected(arch, fp)
    assert sorted(got) == sorted(want) == list(range(N))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=str(uid))


@pytest.mark.parametrize("family", [f for f in FAMILIES if f != "ssm"])
def test_serve_cli_rect(family, capsys):
    """``--rect`` serves every attention family's FP demo teacher on the
    rectangle (``ServeConfig(paged=False)``), prints the reference's
    rectangular-layout line with the rectangle's bytes, and emits the
    tokens of the engine over ``NanoQuantModel.from_fp`` with
    ``paged=False``."""
    arch = FAMILIES[family]
    got = cli.main(["--device", "cpu", "--arch", arch, "--requests", str(N),
                    "--prompt-len", str(PROMPT), "--max-new", str(NEW),
                    "--max-batch", str(BATCH), "--fp", "--rect"])
    out = capsys.readouterr().out
    assert (f"[serve] rectangular layout (paging disabled): {BATCH} x "
            f"{PROMPT + NEW} KV rectangle") in out
    assert "paged KV pool" not in out and "prefix cache" not in out
    want = _expected(arch, True, paged=False)
    assert sorted(got) == sorted(want) == list(range(N))
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=str(uid))


def test_serve_cli_rect_refuses_speculation(capsys):
    """``--rect`` with ``--spec-rank-frac`` is refused before any model is
    built, with the reference's message."""
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--rect", "--spec-rank-frac", "0.5"])
    assert e.value.code == 2
    assert "--spec-rank-frac needs the paged KV pool; drop --rect" in \
        capsys.readouterr().err
