"""The port's grouped GEMM and MoE FFN against the JAX package's, on the CPU.

* The grouped GEMM's plain version (what the wrapper runs on CPU tensors)
  against the reference's Pallas kernel in interpret mode on the shapes of
  its own sweep (``tests/test_kernels.py``), and against ``grouped_gemm_ref``
  on ragged shapes the Pallas kernel does not take.
* ``moe_forward`` against the reference's ``moe_forward_global`` on the
  olmoe and mixtral smoke configs, at capacity factors 8.0 (no token is
  dropped), 1.25 (the configs' own) and 0.25 (many are dropped).
  Tolerances: relative max error 1e-4 in float32 with the aux loss to 1e-5
  and the expert indices equal; 3e-2 in bfloat16 (the reference's
  ``tol_for``) on the token rows whose top-k sets agree.
* Ties: among equal probabilities the port picks the lower expert index
  first, as ``jax.lax.top_k`` does.

Inputs are drawn with numpy from a seed and handed to both packages.
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
from repro.kernels.moe_gemm import grouped_gemm as ref_grouped_gemm  # noqa: E402
from repro.kernels.moe_gemm import grouped_gemm_ref  # noqa: E402
from repro.models.common import init_from_spec  # noqa: E402
from repro.models.moe import moe_capacity as ref_moe_capacity  # noqa: E402
from repro.models.moe import moe_forward_global, moe_spec as ref_moe_spec  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.moe_gemm import grouped_gemm, grouped_gemm_op, grouped_gemm_plain  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from torch_cases import rel_err  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The reference sweep's shapes (e, c, d, f): tests/test_kernels.py.
SWEEP = list(itertools.product([1, 4, 8], [128, 256], [128, 256], [128, 384]))
#: Shapes with no tile divisibility: odd sizes, C = 1, and the decode C = 8.
RAGGED = [(3, 24, 200, 72), (2, 7, 13, 5), (5, 1, 64, 33), (4, 8, 96, 40)]


def gemm_inputs(shape, dtype, seed=0):
    e, c, d, f = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, c, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32)
    ref = (jnp.asarray(x).astype(JNP[dtype]), jnp.asarray(w).astype(JNP[dtype]))
    port = (torch.from_numpy(x).to(TORCH[dtype]), torch.from_numpy(w).to(TORCH[dtype]))
    return ref, port


def as_np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "x".join(map(str, s)))
def test_grouped_gemm_matches_pallas_interpret(shape, dtype):
    (xr, wr), (xp, wp) = gemm_inputs(shape, dtype)
    want = ref_grouped_gemm(xr, wr, interpret=True)
    before = grouped_gemm.launches
    got = grouped_gemm(xp, wp)
    assert grouped_gemm.launches == before  # CPU tensors take the plain version
    assert got.dtype == TORCH[dtype] and tuple(got.shape) == tuple(want.shape)
    assert rel_err(as_np(got), as_np(want)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_grouped_gemm_ragged_matches_reference_oracle(shape, dtype):
    (xr, wr), (xp, wp) = gemm_inputs(shape, dtype, seed=1)
    want = grouped_gemm_ref(xr, wr)
    got = grouped_gemm_op(xp.transpose(1, 2).contiguous().transpose(1, 2), wp)  # strided x
    assert torch.equal(got, grouped_gemm_plain(xp, wp))
    assert rel_err(as_np(got), as_np(want)) <= TOL[dtype]


def test_grouped_gemm_checks_shapes():
    x, w = torch.zeros(2, 3, 4), torch.zeros(2, 5, 6)
    with pytest.raises(ValueError, match=r"want \(E,C,D\) and \(E,D,F\)"):
        grouped_gemm(x, w)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        grouped_gemm(x.to("meta"), torch.zeros(2, 4, 6, device="meta"))


# -- the MoE FFN -------------------------------------------------------------------
def moe_setup(arch, capacity_factor, dtype, seed=0, B=4, S=32):
    """The reference's smoke config and seeded MoE parameters, and an input
    drawn with numpy; the parameters in the port's storage dtype."""
    cfg = dataclasses.replace(ref_configs.get_smoke(arch), capacity_factor=capacity_factor,
                              dtype=dtype)
    params = init_from_spec(ref_moe_spec(cfg), jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed + 1).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    port_params = {k: torch.from_numpy(np.array(v)).to(TORCH[dtype]) for k, v in params.items()}
    return cfg, params, port_params, x


def ref_experts(cfg, params, x):
    """The reference's expert indices (``repro/models/moe.py:67-69``)."""
    dt = JNP[cfg.dtype]
    xf = jnp.asarray(x).astype(dt).reshape(-1, cfg.d_model)
    probs = jax.nn.softmax((xf @ params["router"].astype(dt)).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def port_experts(cfg, port_params, x):
    xf = torch.from_numpy(x).to(TORCH[cfg.dtype]).reshape(-1, cfg.d_model)
    return moe.route(cfg, port_params["router"], xf)[2].numpy()


def run_both(cfg, params, port_params, x):
    want, want_aux = moe_forward_global(cfg, params, jnp.asarray(x).astype(JNP[cfg.dtype]))
    got, probs, counts = moe.moe_forward(cfg, port_params, torch.from_numpy(x).to(TORCH[cfg.dtype]))
    assert got.dtype == TORCH[cfg.dtype] and got.shape == x.shape
    return as_np(got), float(moe.moe_aux(cfg, probs, counts)), as_np(want), float(want_aux)


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_forward_matches_reference_f32(arch, capacity_factor):
    cfg, params, port_params, x = moe_setup(arch, capacity_factor, "float32")
    np.testing.assert_array_equal(port_experts(cfg, port_params, x), ref_experts(cfg, params, x))
    got, got_aux, want, want_aux = run_both(cfg, params, port_params, x)
    print(f"{arch} cf={capacity_factor} f32: relative error {rel_err(got, want)!r}")
    assert rel_err(got, want) <= 1e-4
    assert abs(got_aux - want_aux) <= 1e-5
    if capacity_factor < 1.0:  # tokens were dropped: the output is not the dropless one
        dropless = dataclasses.replace(cfg, capacity_factor=8.0)
        full, _, _ = moe.moe_forward(dropless, port_params, torch.from_numpy(x))
        assert float((full - torch.from_numpy(got)).abs().max()) > 1e-3


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_forward_matches_reference_bf16(arch, capacity_factor):
    """bf16 router logits can tie or flip between two implementations; a
    token routed apart changes its own row (and, with drops, the ranks of
    later tokens), so the rows compared are those whose top-k sets agree."""
    cfg, params, port_params, x = moe_setup(arch, capacity_factor, "bfloat16", seed=2)
    same = np.all(np.sort(port_experts(cfg, port_params, x), -1)
                  == np.sort(ref_experts(cfg, params, x), -1), axis=-1)
    got, got_aux, want, want_aux = run_both(cfg, params, port_params, x)
    rows = same.reshape(x.shape[:2])
    print(f"{arch} cf={capacity_factor} bf16: {int((~same).sum())} of {same.size} rows routed apart; "
          f"relative error on the rest {rel_err(got[rows], want[rows])!r}")
    assert same.mean() >= 0.9
    assert rel_err(got[rows], want[rows]) <= 3e-2
    assert abs(got_aux - want_aux) <= 3e-2 * abs(want_aux)


def test_top_k_breaks_ties_like_jax():
    """Probabilities on a coarse grid (1/8 steps) tie in most rows."""
    probs = (np.random.default_rng(3).integers(0, 8, size=(4096, 64)) / 8).astype(np.float32)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(probs), 8)
    got_vals, got_idx = moe.top_k(torch.from_numpy(probs), 8)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25])
def test_moe_forward_with_all_experts_tied(capacity_factor):
    """A zero router ties every expert for every token: each picks experts
    0..K-1, which at factor 1.25 overflows their capacity, so only the first
    tokens in batch order keep their slots."""
    cfg, params, port_params, x = moe_setup("olmoe-1b-7b", capacity_factor, "float32", seed=4)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    port_params = dict(port_params, router=torch.zeros_like(port_params["router"]))
    experts = port_experts(cfg, port_params, x)
    np.testing.assert_array_equal(experts, ref_experts(cfg, params, x))
    assert (experts == np.arange(cfg.top_k)).all()
    got, got_aux, want, want_aux = run_both(cfg, params, port_params, x)
    assert rel_err(got, want) <= 1e-4 and abs(got_aux - want_aux) <= 1e-5
    T, C = x.shape[0] * x.shape[1], moe.moe_capacity(cfg, x.shape[0] * x.shape[1])
    dropped = np.all(got.reshape(T, -1) == 0.0, axis=-1)
    assert dropped.tolist() == [t >= C for t in range(T)]


def test_capacity_is_the_references():
    for arch in ("olmoe-1b-7b", "mixtral-8x7b"):
        for cf in (0.25, 1.25, 8.0):
            ref_cfg = dataclasses.replace(ref_configs.get(arch), capacity_factor=cf)
            cfg = dataclasses.replace(configs.get(arch), capacity_factor=cf)
            for t in (1, 4, 8, 64, 1000, 2047 * 4, 8192):
                assert moe.moe_capacity(cfg, t) == ref_moe_capacity(ref_cfg, t)
    assert moe.moe_capacity(configs.get("olmoe-1b-7b"), 4 * 2048) == 1280
    assert moe.moe_capacity(configs.get("olmoe-1b-7b"), 8) == 8


def test_moe_spec_is_the_references():
    cfg = configs.get("olmoe-1b-7b")
    assert moe.moe_spec(cfg) == ref_moe_spec(ref_configs.get("olmoe-1b-7b"))
