"""The CUDA attention kernels on the card.

A CUDA kernel has no interpret mode, so these tests need the card: they
skip without one and run there with ``python -m pytest -m cuda
tests/test_torch_attention_cuda.py``.  Each kernel is held to its plain
torch version (relative max error 1e-4 in float32, 3e-2 in bfloat16, the
reference's ``tol_for``) on the shapes ``chip_smoke.py`` checks, the launch
counters count one per call, and the model and the serving engine on the
card agree with ``device="cpu"`` in float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    decode_attention_op,
    decode_attention_plain,
)
from repro_torch.kernels.flash import (  # noqa: E402
    flash_attention,
    flash_attention_op,
    flash_attention_plain,
)
from repro_torch.models import build_from_config, extend_cache  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-6))


def randn(card, seed, *shapes, dtype):
    gen = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(*s, device=card, generator=gen).to(dtype) for s in shapes]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("mask", [(True, None), (False, None), (True, 256)],
                         ids=["causal", "bidirectional", "window256"])
@pytest.mark.parametrize("shape", [(1, 16, 8, 128, 128), (4, 16, 8, 2048, 128),
                                   (1, 4, 1, 100, 64), (1, 15, 5, 513, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kernel_matches_plain(card, shape, mask, dtype):
    B, H, Kv, S, hd = shape
    causal, window = mask
    q, k, v = randn(card, 1, (B, H, S, hd), (B, Kv, S, hd), (B, Kv, S, hd), dtype=dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape,lengths", [((8, 16, 8, 4096, 128), (1, 511, 512, 513, 4096)),
                                           ((4, 15, 5, 1024, 64), (1, 333, 1024))],
                         ids=["main", "g3"])
def test_decode_kernel_matches_plain(card, shape, lengths, dtype):
    B, H, Kv, S, hd = shape
    q, k, v = randn(card, 2, (B, H, hd), (B, Kv, S, hd), (B, Kv, S, hd), dtype=dtype)
    for length in lengths:
        want = decode_attention_plain(q, k, v, length)
        before = decode_attention.launches
        got = decode_attention(q, k, v, length)
        on_card = decode_attention(q, k, v, torch.tensor(length, dtype=torch.int32, device=card))
        assert decode_attention.launches == before + 2
        torch.cuda.synchronize()
        assert rel_err(got, want) <= TOL[dtype], length
        assert torch.equal(got, on_card)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_ops_read_model_layout_views(card, dtype):
    B, S, H, Kv, hd = 2, 300, 16, 8, 128
    q, k, v = randn(card, 3, (B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd), dtype=dtype)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    got = flash_attention_op(q, k, v, window=64)
    assert got.is_contiguous()
    assert rel_err(got, flash_attention_plain(qt, kt, vt, window=64).transpose(1, 2)) <= TOL[dtype]
    got = decode_attention_op(q[:, :1], k, v, 200)
    assert rel_err(got[:, 0], decode_attention_plain(q[:, 0], kt, vt, 200)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("B,S,lengths", [(4, 2112, (2049, 2080, 2112)), (8, 512, (1, 17, 100, 160))],
                         ids=["decode_steps", "engine"])
def test_decode_op_at_main_path_shapes(card, B, S, lengths, dtype):
    """The decode shapes of ``chip_smoke.py`` phase 7, through the op on
    model-layout caches (strided views)."""
    H, Kv, hd = 16, 8, 128
    q, k, v = randn(card, 8, (B, 1, H, hd), (B, S, Kv, hd), (B, S, Kv, hd), dtype=dtype)
    for length in lengths:
        got = decode_attention_op(q, k, v, length)
        want = decode_attention_plain(q[:, 0], k.transpose(1, 2), v.transpose(1, 2), length)
        assert rel_err(got[:, 0], want) <= TOL[dtype], length


def test_kernels_refuse_other_dtypes(card):
    q = torch.zeros(1, 2, 64, 32, device=card, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        decode_attention(q[:, :, 0], q, q, 5)


def smoke_config(arch):
    return dataclasses.replace(configs.get_smoke(arch), dtype="float32")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "smollm-360m"])
def test_model_on_card_matches_cpu_and_counts_launches(card, arch):
    cfg = smoke_config(arch)
    on_card = build_from_config(cfg, device="cuda", seed=4)
    on_cpu = build_from_config(cfg, device="cpu")
    on_cpu.load_state_dict({k: v.cpu() for k, v in on_card.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 12)))
    flash_before, decode_before = flash_attention.launches, decode_attention.launches
    want, _, _ = on_cpu.forward({"tokens": toks})
    got, _, _ = on_card.forward({"tokens": toks.to(card)})
    assert flash_attention.launches == flash_before + cfg.n_layers
    assert rel_err(got.cpu(), want) <= 1e-4
    _, cache_card = on_card.prefill({"tokens": toks[:, :8].to(card)})
    _, cache_cpu = on_cpu.prefill({"tokens": toks[:, :8]})
    cache_card, cache_cpu = extend_cache(on_card, cache_card, 10), extend_cache(on_cpu, cache_cpu, 10)
    for pos in range(8, 12):  # the last two steps write past the cache's end
        got, cache_card = on_card.decode_step(cache_card, toks[:, pos:pos + 1].to(card), pos)
        want, cache_cpu = on_cpu.decode_step(cache_cpu, toks[:, pos:pos + 1], pos)
        assert rel_err(got.cpu(), want) <= 1e-4, pos
    assert decode_attention.launches == decode_before + 4 * cfg.n_layers


def test_engine_on_card_matches_cpu(card):
    cfg = smoke_config("qwen3-0.6b")
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
