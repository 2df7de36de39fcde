"""The port's attention kernels' plain versions against the JAX package.

Inputs are made with numpy from a seed and go through the reference's
oracles (``attention_ref``, ``decode_attention_ref``), its Pallas kernels in
interpret mode, and its model-layout ops, and through the port's wrappers
on CPU tensors (which take the plain versions).  Tolerances: relative max
error 1e-5 in float32 (summation order only) and 3e-2 in bfloat16 (the
reference's ``tol_for``; the reference rounds scores to bf16, the port
keeps them in f32).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attn import (  # noqa: E402
    decode_attention as ref_decode,
    decode_attention_op as ref_decode_op,
    decode_attention_ref,
)
from repro.kernels.flash import (  # noqa: E402
    attention_ref,
    flash_attention as ref_flash,
    flash_attention_op as ref_flash_op,
)
from repro_torch.kernels.decode_attn import (  # noqa: E402
    decode_attention,
    decode_attention_op,
    decode_attention_plain,
)
from repro_torch.kernels.decode_attn.decode_attention import split_plan  # noqa: E402
from repro_torch.kernels.flash import (  # noqa: E402
    flash_attention,
    flash_attention_op,
    flash_attention_plain,
)
from torch_cases import rel_err  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def inputs(seed, *shapes, dtype="float32"):
    """Standard-normal arrays from a numpy seed, as (jax, torch) pairs of
    the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)))
    return out


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# (B, H, Kv, S, hd): kv groups G = 1, 2 and 3, ragged S, narrow and wide hd.
FLASH_SHAPES = [(1, 2, 2, 128, 128), (2, 4, 2, 256, 64), (1, 6, 2, 100, 32)]
MASKS = [("causal", True, None), ("bidirectional", False, None), ("window", True, 48)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_plain_matches_reference(shape, mask, dtype):
    B, H, Kv, S, hd = shape
    _, causal, window = mask
    (qj, qt), (kj, kt), (vj, vt) = inputs(1, (B, H, S, hd), (B, Kv, S, hd), (B, Kv, S, hd),
                                          dtype=dtype)
    tol = DTYPES[dtype][2]
    got = flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = attention_ref(qj, kj, vj, causal=causal, window=window)
    assert rel_err(as_np(got), as_np(want)) <= tol
    pallas = ref_flash(qj, kj, vj, causal=causal, window=window, interpret=True)
    assert rel_err(as_np(got), as_np(pallas)) <= tol
    assert flash_attention.launches == 0  # the CPU path launches no kernel


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
def test_flash_op_model_layout(mask, dtype):
    B, S, H, Kv, hd = 2, 128, 4, 2, 32
    _, causal, window = mask
    (qj, qt), (kj, kt), (vj, vt) = inputs(2, (B, S, H, hd), (B, S, Kv, hd), (B, S, Kv, hd),
                                          dtype=dtype)
    got = flash_attention_op(qt, kt, vt, causal=causal, window=window)
    assert got.shape == (B, S, H, hd) and got.is_contiguous()
    want = ref_flash_op(qj, kj, vj, causal=causal, window=window, interpret=True)
    assert rel_err(as_np(got), as_np(want)) <= DTYPES[dtype][2]
    plain = flash_attention_plain(qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2),
                                  causal=causal, window=window)
    assert torch.equal(got, plain.transpose(1, 2))


def test_flash_plain_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q, torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 9, 16))
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q[:, :2], q[:, :2], window=0)
    out = torch.empty(1, 4, 8, 16)
    assert flash_attention(q, q[:, :2], q[:, :2], out=out) is out


# (B, H, Kv, S, hd) and the cache lengths attended to (ragged, 1, S - 1, S, past S).
DECODE_SHAPES = [(2, 4, 2, 256, 64), (1, 3, 1, 192, 32), (3, 6, 2, 128, 32)]
LENGTHS = [1, 37, 64, 65, 127, 128, 300]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_plain_matches_reference(shape, dtype):
    B, H, Kv, S, hd = shape
    (qj, qt), (kj, kt), (vj, vt) = inputs(3, (B, H, hd), (B, Kv, S, hd), (B, Kv, S, hd),
                                          dtype=dtype)
    tol = DTYPES[dtype][2]
    for length in [n for n in LENGTHS if n <= S] + [S - 1, S, S + 5]:
        got = decode_attention(qt, kt, vt, length)
        assert got.dtype == qt.dtype and got.shape == qt.shape
        # A traced length: a Python int would recompile every op per value.
        want = decode_attention_ref(qj, kj, vj, jnp.int32(length))
        assert rel_err(as_np(got), as_np(want)) <= tol, length
        if length in (65, S):  # interpret mode is slow: two lengths
            pallas = ref_decode(qj, kj, vj, jnp.int32(length), block_k=64, interpret=True)
            assert rel_err(as_np(got), as_np(pallas)) <= tol, length
        as_tensor = decode_attention(qt, kt, vt, torch.tensor(length, dtype=torch.int32))
        assert torch.equal(got, as_tensor)
    assert decode_attention.launches == 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_op_model_layout(dtype):
    B, S, H, Kv, hd = 2, 128, 6, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = inputs(4, (B, 1, H, hd), (B, S, Kv, hd), (B, S, Kv, hd),
                                          dtype=dtype)
    for length in (1, 128):
        got = decode_attention_op(qt, kt, vt, length)
        assert got.shape == (B, 1, H, hd)
        want = ref_decode_op(qj, kj, vj, length, block_k=64, interpret=True)
        assert rel_err(as_np(got), as_np(want)) <= DTYPES[dtype][2]
        plain = decode_attention_plain(qt[:, 0], kt.transpose(1, 2), vt.transpose(1, 2), length)
        assert torch.equal(got, plain[:, None])


def test_decode_plain_is_flash_on_the_last_row():
    """One query at position S - 1 against S rows is the last row of causal
    flash attention over those rows."""
    (_, q), (_, k), (_, v) = inputs(5, (2, 4, 96, 32), (2, 2, 96, 32), (2, 2, 96, 32))
    full = flash_attention_plain(q, k, v, causal=True)
    last = decode_attention_plain(q[:, :, -1], k, v, 96)
    assert rel_err(last.numpy(), full[:, :, -1].numpy()) <= 1e-6


def test_decode_rejects_an_empty_length():
    q, k = torch.zeros(1, 2, 8), torch.zeros(1, 1, 16, 8)
    with pytest.raises(ValueError, match="length"):
        decode_attention(q, k, k, 0)


@pytest.mark.parametrize("B,Kv,S", [(8, 8, 4096), (8, 8, 512), (1, 1, 100), (4, 8, 2112),
                                    (1, 1, 1), (64, 16, 8192)])
def test_split_plan_covers_the_cache(B, Kv, S):
    n_split, rows = split_plan(B, Kv, S)
    assert 1 <= n_split <= 256
    assert (n_split - 1) * rows < S <= n_split * rows
