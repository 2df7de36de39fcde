"""The port's RG-LRU scan and recurrent block against the JAX package's, on
the CPU.

* ``rglru_scan_plain`` (what the wrapper runs on CPU tensors) against the
  reference's Pallas kernel in interpret mode on the shapes of its own sweep
  (``tests/test_kernels.py``, random ``h0``), and against ``rglru_scan_ref``
  on shapes the Pallas kernel does not take: S = 1, S = 2047, odd D.
* ``rglru_forward`` and ``rglru_step`` against the reference's on
  recurrentgemma's smoke config; a forward followed by steps equals the
  forward over the longer sequence (the ``h`` and ``conv`` states carry);
  the step updates its state in place.

Tolerances: relative max error 1e-4 in float32 and 3e-2 in bfloat16 (the
reference's ``tol_for``); the reference model's ``associative_scan`` adds in
another order than the sequential loop.  Inputs are drawn with numpy from
a seed and handed to both packages.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.kernels.rglru import rglru_scan as ref_rglru_scan  # noqa: E402
from repro.kernels.rglru import rglru_scan_ref  # noqa: E402
from repro.models import recurrent as ref_rec  # noqa: E402
from repro.models.common import init_from_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.rglru import rglru_scan, rglru_scan_op, rglru_scan_plain  # noqa: E402
from repro_torch.models import recurrent as rec  # noqa: E402
from torch_cases import rel_err  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The reference sweep's shapes (b, s, d) with a time block that divides s
#: (tests/test_kernels.py draws the block from 64, 128 and 256).
SWEEP = [(b, s, d, blk) for (b, s, d), blk in zip(
    itertools.product([1, 3], [128, 256, 512], [64, 128]), itertools.cycle([64, 128, 256]))]
#: Shapes without block divisibility: one step, the forward check's 2047
#: steps, odd widths.
RAGGED = [(2, 1, 64), (1, 2047, 8), (3, 100, 37), (2, 33, 1)]


def scan_inputs(b, s, d, dtype, seed=0):
    """a in (0, 1) (a sigmoid, as the reference sweep draws it), x and a
    random f32 h0; (reference arrays, port tensors)."""
    rng = np.random.default_rng(seed)
    a = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, d))))).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    ref = (jnp.asarray(a).astype(JNP[dtype]), jnp.asarray(x).astype(JNP[dtype]), jnp.asarray(h0))
    port = (torch.from_numpy(a).to(TORCH[dtype]), torch.from_numpy(x).to(TORCH[dtype]), torch.from_numpy(h0))
    return ref, port


def as_np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("b,s,d,blk", SWEEP, ids=lambda v: str(v))
def test_scan_matches_pallas_interpret(b, s, d, blk, dtype):
    ref, (a, x, h0) = scan_inputs(b, s, d, dtype)
    want = ref_rglru_scan(*ref, block_t=blk, interpret=True)
    before = rglru_scan.launches
    got = rglru_scan(a, x, h0)
    assert rglru_scan.launches == before  # CPU tensors take the plain version
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    assert rel_err(as_np(got), as_np(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_scan_matches_reference_oracle_on_any_shape(shape, dtype):
    ref, (a, x, h0) = scan_inputs(*shape, dtype, seed=1)
    want = rglru_scan_ref(*ref)
    got = rglru_scan_plain(a, x, h0)
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == shape
    assert rel_err(as_np(got), as_np(want)) <= TOL[dtype]
    assert torch.equal(rglru_scan_op(a, x, h0), got)


def test_scan_plain_is_the_sequential_recurrence():
    """Bit for bit ``h = a * h + x`` in f32, one step at a time, from h0; a
    zero gate restarts the recurrence at x."""
    _, (a, x, h0) = scan_inputs(2, 9, 5, "float32", seed=2)
    a[:, 4] = 0.0
    got = rglru_scan_plain(a, x, h0)
    h = h0.clone()
    for t in range(9):
        h = a[:, t] * h + x[:, t]
        assert torch.equal(got[:, t], h), t
    assert torch.equal(got[:, 4], x[:, 4])


def test_scan_refuses_mismatched_shapes():
    a = torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match=r"\(B,S,D\)"):
        rglru_scan(a, torch.zeros(2, 5, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError, match=r"\(B,D\)"):
        rglru_scan_plain(a, a, torch.zeros(2, 4))
    with pytest.raises(ValueError, match="use a CUDA device or the CPU"):
        rglru_scan(a.to("meta"), a.to("meta"), torch.zeros(2, 8, device="meta"))


# -- the recurrent block -----------------------------------------------------------
def smoke(dtype):
    return dataclasses.replace(ref_configs.get_smoke("recurrentgemma-9b"), dtype=dtype)


def block_params(cfg, seed):
    """The reference's seeded RG-LRU parameters (f32 arrays, with a nonzero
    conv bias and gate biases) and the port's, stored as the port's
    ``Model`` stores them: matrices in the compute dtype, vectors in f32."""
    params = init_from_spec(ref_rec.rglru_spec(cfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "b_rec_gate", "b_inp_gate"):
        params[name] = jnp.asarray(rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1)
    dt = TORCH[cfg.dtype]
    port = {n: torch.from_numpy(np.array(v)).to(dt if v.ndim >= 2 else torch.float32)
            for n, v in params.items()}
    return params, port


def hidden(cfg, B, S, seed):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x).astype(JNP[cfg.dtype]), torch.from_numpy(x).to(TORCH[cfg.dtype])


def test_spec_is_the_references():
    cfg = configs.get_smoke("recurrentgemma-9b")
    assert rec.rglru_spec(cfg) == ref_rec.rglru_spec(smoke("bfloat16"))
    assert rec._RGLRU_C == ref_rec._RGLRU_C == 8.0


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-5.0, 5.0, 101).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = rec._gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(exact - want)) > 1e-4  # the erf form would not do


@pytest.mark.parametrize("dtype", list(TOL))
def test_forward_and_steps_match_reference(dtype):
    cfg = smoke(dtype)
    params, p = block_params(cfg, seed=3)
    B, S, steps = 2, 7, 4
    x_ref, x = hidden(cfg, B, S + steps, seed=4)
    want, ref_state = jax.jit(lambda p_, x_: ref_rec.rglru_forward(cfg, p_, x_))(params, x_ref[:, :S])
    got, state = rec.rglru_forward(cfg, p, x[:, :S])
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == (B, S, cfg.d_model)
    assert rel_err(as_np(got), as_np(want)) <= TOL[dtype]
    assert state["h"].dtype == torch.float32 and tuple(state["conv"].shape) == (B, 3, cfg.d_model)
    assert rel_err(as_np(state["h"]), as_np(ref_state["h"])) <= TOL[dtype]
    assert rel_err(as_np(state["conv"]), as_np(ref_state["conv"])) <= TOL[dtype]
    step = jax.jit(lambda p_, x_, s_: ref_rec.rglru_step(cfg, p_, x_, s_))
    for t in range(S, S + steps):
        want_t, ref_state = step(params, x_ref[:, t:t + 1], ref_state)
        got_t, out_state = rec.rglru_step(cfg, p, x[:, t:t + 1], state)
        assert out_state is state
        assert rel_err(as_np(got_t), as_np(want_t)) <= TOL[dtype], t
        assert rel_err(as_np(state["h"]), as_np(ref_state["h"])) <= TOL[dtype], t


@pytest.mark.parametrize("dtype", list(TOL))
def test_step_from_init_state_matches_reference(dtype):
    """Decoding from the zero state (as the serving engine does) with the
    reference's f32 initial state."""
    cfg = smoke(dtype)
    params, p = block_params(cfg, seed=5)
    x_ref, x = hidden(cfg, 3, 5, seed=6)
    ref_state = ref_rec.rglru_init_state(cfg, 3)
    state = rec.rglru_init_state(cfg, 3, torch.device("cpu"))
    for name in ("h", "conv"):
        assert state[name].dtype == torch.float32
        assert tuple(state[name].shape) == ref_state[name].shape
    for t in range(5):
        want_t, ref_state = ref_rec.rglru_step(cfg, params, x_ref[:, t:t + 1], ref_state)
        got_t, _ = rec.rglru_step(cfg, p, x[:, t:t + 1], state)
        assert rel_err(as_np(got_t), as_np(want_t)) <= TOL[dtype], t


@pytest.mark.parametrize("split", [1, 3, 6])
def test_forward_then_steps_equals_the_longer_forward(split):
    """The state after a forward over the first ``split`` tokens, stepped
    over the rest, gives the longer forward's outputs: ``h`` and the last
    three conv inputs carry (split = 1 and 3 leave zeros of the conv's
    padding in the state)."""
    cfg = smoke("float32")
    _, p = block_params(cfg, seed=7)
    _, x = hidden(cfg, 2, 9, seed=8)
    full, full_state = rec.rglru_forward(cfg, p, x)
    _, state = rec.rglru_forward(cfg, p, x[:, :split])
    for t in range(split, 9):
        out, _ = rec.rglru_step(cfg, p, x[:, t:t + 1], state)
        assert rel_err(out.numpy(), full[:, t:t + 1].numpy()) <= 1e-5, t
    assert rel_err(state["h"].numpy(), full_state["h"].numpy()) <= 1e-5
    assert rel_err(state["conv"].numpy(), full_state["conv"].numpy()) <= 1e-5


def test_forward_state_is_not_a_view_of_the_forward():
    cfg = smoke("float32")
    _, p = block_params(cfg, seed=9)
    _, x = hidden(cfg, 2, 6, seed=10)
    _, state = rec.rglru_forward(cfg, p, x)
    for t in state.values():
        assert t._base is None and t.is_contiguous()
