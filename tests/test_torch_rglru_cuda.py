"""The CUDA RG-LRU scan kernel and the hybrid recurrent model on the card.

A CUDA kernel has no interpret mode, so these tests need the card: they
skip without one and run there with ``python -m pytest -m cuda
tests/test_torch_rglru_cuda.py``.  The kernel is held to its plain torch
version (relative max error 1e-4 in float32, 3e-2 in bfloat16, the
reference's ``tol_for``; the kernel composes its time chunks in another
order than the sequential loop) on the shapes ``chip_smoke.py`` phase 6
checks, the launch counter counts one per call, and recurrentgemma's smoke
model and the serving engine on the card agree with ``device="cpu"`` in
float32, with one scan launch per "rglru" layer and forward and none per
decode step.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash import flash_attention  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_op, rglru_scan_plain  # noqa: E402
from repro_torch.models import build_from_config, extend_cache  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]
#: recurrentgemma-9b's forward (4 x 2048 tokens) and forward-check (2047)
#: shapes; the reference sweep's shapes; one step, odd widths.
MAIN_PATH = [(4, 2048, 4096), (4, 2047, 4096)]
SWEEP = list(itertools.product([1, 3], [128, 256, 512], [64, 128]))
RAGGED = [(2, 1, 64), (1, 2047, 8), (3, 100, 37), (2, 33, 1), (5, 129, 4097)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def inputs(card, shape, dtype, seed=1, zero_h0=False):
    B, S, D = shape
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.sigmoid(torch.randn(B, S, D, device=card, generator=gen)).to(dtype)
    x = torch.randn(B, S, D, device=card, generator=gen).to(dtype)
    h0 = torch.zeros(B, D, device=card) if zero_h0 else torch.randn(B, D, device=card, generator=gen)
    return a, x, h0


@pytest.mark.parametrize("zero_h0", [True, False], ids=["h0=0", "h0=randn"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", MAIN_PATH + SWEEP + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_scan_matches_plain(card, shape, dtype, zero_h0):
    a, x, h0 = inputs(card, shape, dtype, zero_h0=zero_h0)
    before = rglru_scan.launches
    got = rglru_scan(a, x, h0)
    assert rglru_scan.launches == before + 1
    want = rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert rel_err(got, want) <= TOL[dtype]


def test_scan_refuses_what_the_kernel_does_not_take(card):
    a, x, h0 = inputs(card, (2, 8, 16), torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rglru_scan(a.half(), x.half(), h0)
    with pytest.raises(TypeError, match="mixed dtypes"):
        rglru_scan(a, x.bfloat16(), h0)
    with pytest.raises(TypeError, match="h0"):
        rglru_scan(a, x, h0.bfloat16())
    wide = torch.zeros(2, 8, 32, device=card)[:, :, :16]  # unit innermost stride, rows 32 apart
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(wide, x, h0)
    assert torch.equal(rglru_scan_op(wide, x, h0), rglru_scan(wide.contiguous(), x, h0))


def smoke_config():
    return dataclasses.replace(configs.get_smoke("recurrentgemma-9b"), dtype="float32")


def test_recurrent_model_on_card_matches_cpu_and_counts_launches(card):
    cfg = smoke_config()
    kinds = cfg.layer_kinds()
    n_rglru, n_attn = kinds.count("rglru"), len(kinds) - kinds.count("rglru")
    on_card = build_from_config(cfg, device="cuda", seed=4)
    on_cpu = build_from_config(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 24)))
    scans, flashes = rglru_scan.launches, flash_attention.launches
    want, _, _ = on_cpu.forward({"tokens": toks})
    got, _, _ = on_card.forward({"tokens": toks.to(card)})
    assert (rglru_scan.launches - scans, flash_attention.launches - flashes) == (n_rglru, n_attn)
    assert rel_err(got.cpu(), want) <= 1e-4
    _, cache_card = on_card.prefill({"tokens": toks[:, :18].to(card)})
    _, cache_cpu = on_cpu.prefill({"tokens": toks[:, :18]})
    cache_card, cache_cpu = extend_cache(on_card, cache_card, 24), extend_cache(on_cpu, cache_cpu, 24)
    scans = rglru_scan.launches
    for pos in range(18, 24):  # the window-16 ring wraps
        got, cache_card = on_card.decode_step(cache_card, toks[:, pos:pos + 1].to(card), pos)
        want, cache_cpu = on_cpu.decode_step(cache_cpu, toks[:, pos:pos + 1], pos)
        assert rel_err(got.cpu(), want) <= 1e-4, pos
    assert rglru_scan.launches == scans


def test_recurrent_engine_on_card_matches_cpu(card):
    cfg = smoke_config()
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
