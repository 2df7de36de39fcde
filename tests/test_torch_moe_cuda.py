"""The CUDA grouped-GEMM kernel and the MoE model on the card.

A CUDA kernel has no interpret mode, so these tests need the card: they
skip without one and run there with ``python -m pytest -m cuda
tests/test_torch_moe_cuda.py``.  The kernel is held to its plain torch
version (relative max error 1e-4 in float32, 3e-2 in bfloat16, the
reference's ``tol_for``) on the shapes ``chip_smoke.py`` phase 6 checks,
the launch counter counts one per call, and the MoE smoke model and the
serving engine on the card agree with ``device="cpu"`` in float32.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.moe_gemm import grouped_gemm, grouped_gemm_op, grouped_gemm_plain  # noqa: E402
from repro_torch.models import build_from_config, extend_cache  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
#: olmoe-1b-7b's prefill (4 x 2048 tokens, C = 1280) and decode (C = 8)
#: shapes, for wi/wu and for wd.
MAIN_PATH = [(64, 1280, 2048, 1024), (64, 1280, 1024, 2048), (64, 8, 2048, 1024), (64, 8, 1024, 2048)]
SWEEP = list(itertools.product([1, 4, 8], [128, 256], [128, 256], [128, 384]))
RAGGED = [(3, 24, 200, 72), (2, 7, 13, 5), (5, 1, 64, 33), (4, 8, 96, 40), (2, 130, 36, 129)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def inputs(card, shape, dtype, seed=1):
    E, C, D, F = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(E, C, D, device=card, generator=gen).to(dtype)
    w = (torch.randn(E, D, F, device=card, generator=gen) * 0.05).to(dtype)
    return x, w


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", MAIN_PATH + SWEEP + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_grouped_gemm_matches_plain(card, shape, dtype):
    x, w = inputs(card, shape, dtype)
    before = grouped_gemm.launches
    got = grouped_gemm(x, w)
    assert grouped_gemm.launches == before + 1
    want = grouped_gemm_plain(x, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert rel_err(got, want) <= TOL[dtype]


def test_grouped_gemm_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros(2, 8, 16, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        grouped_gemm(x, x.transpose(1, 2).contiguous())
    x = torch.zeros(2, 16, 32, device=card)[:, :8, :16]  # unit innermost stride, rows 32 apart
    with pytest.raises(ValueError, match="contiguous"):
        grouped_gemm(x, torch.zeros(2, 16, 4, device=card))
    assert torch.equal(grouped_gemm_op(x, torch.ones(2, 16, 4, device=card)),
                       torch.zeros(2, 8, 4, device=card))


def smoke_config(arch):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_model_on_card_matches_cpu_and_counts_launches(card, arch):
    cfg = smoke_config(arch)
    on_card = build_from_config(cfg, device="cuda", seed=4)
    on_cpu = build_from_config(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 12)))
    before = grouped_gemm.launches
    want, want_aux, _ = on_cpu.forward({"tokens": toks})
    got, aux, _ = on_card.forward({"tokens": toks.to(card)})
    assert grouped_gemm.launches == before + 3 * cfg.n_layers
    assert rel_err(got.cpu(), want) <= 1e-4
    assert abs(float(aux) - float(want_aux)) <= 1e-5
    _, cache_card = on_card.prefill({"tokens": toks[:, :8].to(card)})
    _, cache_cpu = on_cpu.prefill({"tokens": toks[:, :8]})
    cache_card, cache_cpu = extend_cache(on_card, cache_card, 12), extend_cache(on_cpu, cache_cpu, 12)
    before = grouped_gemm.launches
    for pos in range(8, 12):
        got, cache_card = on_card.decode_step(cache_card, toks[:, pos:pos + 1].to(card), pos)
        want, cache_cpu = on_cpu.decode_step(cache_cpu, toks[:, pos:pos + 1], pos)
        assert rel_err(got.cpu(), want) <= 1e-4, pos
    assert grouped_gemm.launches == before + 4 * 3 * cfg.n_layers


def test_moe_engine_on_card_matches_cpu(card):
    cfg = smoke_config("olmoe-1b-7b")
    on_card = build_from_config(cfg, device="cuda", seed=6)
    on_cpu = build_from_config(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    rng = np.random.default_rng(7)
    specs = [(int(rng.integers(3, 10)), int(rng.integers(2, 8))) for _ in range(7)]

    def serve(model):
        reqs = [Request(i, np.random.default_rng(i).integers(0, cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=new) for i, (n, new) in enumerate(specs)]
        return [r.output for r in ServingEngine(model, 3, 32).run(reqs)]

    assert serve(on_card) == serve(on_cpu)
