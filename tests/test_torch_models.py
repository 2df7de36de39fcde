"""The port's language model against the JAX package's, on the CPU.

The reference's seeded parameters are carried into the port with
``params_from_jax``; then ``forward`` logits, ``prefill`` logits and several
teacher-forced ``decode_step``s (past the sliding window, and past the end
of a full cache, where the slot clamps) are compared, and so is the aux
loss that ``forward`` sums over the MoE layers.  recurrentgemma's smoke
config and a 5-layer variant carry RG-LRU states through prefill and
decode; its local layer's ring wraps.  Tolerances: relative max
error 1e-4 with ``dtype="float32"`` and 3e-2 as shipped in bfloat16 (the
reference's ``tol_for``; the reference forms attention scores in the
compute dtype, the port in f32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import extend_cache as ref_extend_cache  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import Model, build, extend_cache  # noqa: E402
from torch_cases import lm_pair, rel_err  # noqa: E402


def local_config():
    """qwen3's smoke config with alternating sliding-window and global layers."""
    return dataclasses.replace(ref_configs.get_smoke("qwen3-0.6b"), pattern=("local", "attn"),
                               window=4, n_layers=3)


def recurrent_tail_config():
    """recurrentgemma's smoke config at 5 layers: one ("rglru", "rglru",
    "local") group and a tail of two "rglru" layers, which the reference
    keeps unscanned as ``tail/tail{0,1}_rglru``."""
    return dataclasses.replace(ref_configs.get_smoke("recurrentgemma-9b"), n_layers=5)


CONFIGS = {
    "qwen3": lambda: ref_configs.get_smoke("qwen3-0.6b"),
    "smollm": lambda: ref_configs.get_smoke("smollm-360m"),
    "qwen3-local": local_config,
    "olmoe": lambda: ref_configs.get_smoke("olmoe-1b-7b"),
    "mixtral": lambda: ref_configs.get_smoke("mixtral-8x7b"),
    # RG-LRU layers with a window-16 local layer: the ring wraps in the
    # decode steps of test_model_matches_reference (a cache of 9 rows).
    "recurrentgemma": lambda: ref_configs.get_smoke("recurrentgemma-9b"),
    "recurrentgemma-tail": recurrent_tail_config,
}
DTYPES = {"float32": 1e-4, "bfloat16": 3e-2}


def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S)).astype(np.int32)


def logits_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture
def routes(monkeypatch):
    """Records the expert indices that the reference and the port choose at
    each MoE call, in call order; ``routes.apart(B)`` then says which batch
    rows had a token routed to another expert set at some call, and clears
    the record.  In bf16 two correct paths whose router logits differ in the
    last bit can route a token apart; its row then differs by far more than
    rounding, so the logits of such rows are not compared."""
    import repro.models.moe as ref_moe
    from repro_torch.models import moe as port_moe

    record = {"ref": [], "port": []}
    ref_global, port_route = ref_moe.moe_forward_global, port_moe.route

    def ref_forward(cfg, p, x):  # the reference's routing (repro/models/moe.py:66-69)
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xf @ p["router"].astype(x.dtype)).astype(jnp.float32), axis=-1)
        jax.debug.callback(lambda i: record["ref"].append(np.asarray(i)),
                           jax.lax.top_k(probs, cfg.top_k)[1], ordered=True)
        return ref_global(cfg, p, x)

    def route(cfg, router, xf):
        out = port_route(cfg, router, xf)
        record["port"].append(out[2].numpy())
        return out

    monkeypatch.setattr(ref_moe, "moe_forward_global", ref_forward)
    monkeypatch.setattr(port_moe, "route", route)

    class Routes:
        @staticmethod
        def apart(B):
            jax.effects_barrier()
            assert len(record["ref"]) == len(record["port"])
            rows = np.zeros(B, bool)
            for r, p in zip(record["ref"], record["port"]):
                rows |= np.any(np.sort(r, -1) != np.sort(p, -1), -1).reshape(B, -1).any(-1)
            record["ref"].clear()
            record["port"].clear()
            return rows

    return Routes


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_model_matches_reference(name, dtype, routes):
    cfg = dataclasses.replace(CONFIGS[name](), dtype=dtype)
    tol = DTYPES[dtype]
    ref, params, port = lm_pair(cfg, seed=3)
    B, S, steps = 2, 6, 5
    toks = tokens(cfg.vocab, B, S + steps, seed=4)
    prompt = toks[:, :S]

    def compare(got, want, apart, label):
        """Rows routed alike within ``tol``; in f32 no row may be routed apart."""
        print(f"{name} {dtype} {label}: {int(apart.sum())} of {B} rows routed apart")
        assert dtype == "bfloat16" or not apart.any(), label
        assert not apart.all(), label
        assert rel_err(logits_np(got)[~apart], logits_np(want)[~apart]) <= tol, label

    want, want_aux, _ = jax.jit(ref.forward)(params, {"tokens": jnp.asarray(toks)})
    got, aux, _ = port.forward({"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, S + steps, cfg.vocab) and aux.dtype == torch.float32
    apart = routes.apart(B)
    compare(got, want, apart, "forward")
    assert (float(aux) > 0.0) == (cfg.n_experts > 0)
    if not apart.any():  # a token routed apart moves the load-balancing counts
        assert abs(float(aux) - float(want_aux)) <= tol * max(1.0, abs(float(want_aux)))

    want_last, ref_cache = jax.jit(ref.prefill)(params, {"tokens": jnp.asarray(prompt)})
    got_last, port_cache = port.prefill({"tokens": torch.from_numpy(prompt).long()})
    assert got_last.shape == (B, 1, cfg.vocab)
    apart = routes.apart(B)
    compare(got_last, want_last, apart, "prefill")

    # Full caches two rows short of the steps: the last two steps write past
    # the end (slot clamps); the window layers wrap their ring buffer.
    max_seq = S + steps - 2
    ref_cache = ref_extend_cache(ref, ref_cache, max_seq)
    port_cache = extend_cache(port, port_cache, max_seq)
    ref_step = jax.jit(ref.decode_step)
    for t in range(steps):
        tok = toks[:, S + t:S + t + 1]
        want_t, ref_cache = ref_step(params, ref_cache, jnp.asarray(tok), jnp.int32(S + t))
        got_t, port_cache = port.decode_step(port_cache, torch.from_numpy(tok).long(), S + t)
        apart |= routes.apart(B)  # a row's earlier tokens reach it through the cache
        compare(got_t, want_t, apart, f"step {t}")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_then_decode_matches_forward(name):
    """The port's own prefill → extend_cache → decode_step equals the last
    row of ``forward`` (the reference's ``test_models_smoke`` check, with
    its tolerance).  MoE configs run at the dropless capacity factor E / K:
    the forward over S + 1 tokens would otherwise drop slots that the
    decode step (C = 8 >= B) keeps."""
    cfg = configs.base.ModelConfig(**dataclasses.asdict(CONFIGS[name]()))
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = Model(cfg, device="cpu").init_params(torch.Generator().manual_seed(5))
    B, S = 2, 8
    toks = torch.from_numpy(tokens(cfg.vocab, B, S + 1, seed=6)).long()
    full, _, _ = model.forward({"tokens": toks})
    last, cache = model.prefill({"tokens": toks[:, :S]})
    assert torch.equal(last[:, 0], full[:, S - 1])
    cache = extend_cache(model, cache, S + 4)
    dec, new_cache = model.decode_step(cache, toks[:, S:], S)
    assert new_cache is cache
    assert rel_err(logits_np(dec[:, 0]), logits_np(full[:, -1])) <= 1e-3


def test_only_forward_computes_the_aux_loss(monkeypatch):
    """``forward`` sums the aux loss of every MoE layer; a decode step drops
    it, as the reference does, and so computes none."""
    from repro_torch.models import moe

    calls = []
    real_aux = moe.moe_aux
    monkeypatch.setattr(moe, "moe_aux", lambda *a: calls.append(1) or real_aux(*a))
    model = build("olmoe-1b-7b", smoke=True, device="cpu", seed=3)
    toks = torch.from_numpy(tokens(model.cfg.vocab, 2, 5, seed=4)).long()
    _, aux, _ = model.forward({"tokens": toks})
    assert len(calls) == model.cfg.n_layers and float(aux) > 0.0
    model.decode_step(model.init_cache(2, 8), toks[:, :1], 0)
    assert len(calls) == model.cfg.n_layers


def test_seeded_weights_are_reproducible_and_truncated():
    a = build("qwen3-0.6b", smoke=True, device="cpu", seed=7)
    b = build("qwen3-0.6b", smoke=True, device="cpu", seed=7)
    c = build("qwen3-0.6b", smoke=True, device="cpu", seed=8)
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.embed_table, c.embed_table)
    w = a.layers[0].wq.float()
    assert w.abs().max() <= 0.04 * (1 + 2**-8)  # ±2σ, then rounded to bf16
    assert 0.01 < float(w.std()) < 0.03
    assert torch.equal(a.layers[1].q_norm, torch.ones_like(a.layers[1].q_norm))
    assert a.embed_table.dtype == torch.bfloat16 and a.final_norm.dtype == torch.float32
    assert len(a.layers) == a.cfg.n_layers


@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-large-v3", "phi-3-vision-4.2b"])
def test_later_slices_raise(arch):
    with pytest.raises(NotImplementedError):
        build(arch, smoke=True, device="cpu")


def spec_count(specs) -> int:
    """Parameters in a reference spec tree, counted from the shapes."""
    if isinstance(specs, tuple):
        return int(np.prod(specs[0]))
    return sum(spec_count(v) for v in specs.values())


def test_recurrentgemma_builds():
    """The hybrid model builds: RG-LRU layers with their SwiGLU FFN between
    local attention layers, recurrent states in its decode cache, and at
    full size (counted from the specs, nothing allocated) the reference's
    10,444,984,320 parameters."""
    from repro.models.lm import Model as RefModel
    from repro_torch.models import blocks

    model = build("recurrentgemma-9b", smoke=True, device="cpu", seed=1)
    kinds = [layer.kind for layer in model.layers]
    assert kinds == ["rglru", "rglru", "local"]
    assert {"w_in_x", "conv_w", "lambda_p", "w_out", "ln2", "wi"} <= set(model.layers[0].spec)
    assert model.layers[0].conv_b.dtype == torch.float32 and model.layers[0].conv_w.dtype == torch.bfloat16
    cache = model.init_cache(2, 32)
    assert set(cache[0]) == {"h", "conv"} and tuple(cache[0]["conv"].shape) == (2, 3, model.cfg.d_model)
    assert tuple(cache[2]["k"].shape) == (2, 16, 1, model.cfg.head_dim)  # min(window, max_seq) rows
    cfg = configs.get("recurrentgemma-9b")
    D, V = cfg.d_model, cfg.vocab
    port_count = 2 * V * D + D + sum(
        spec_count(blocks.block_spec(cfg, kind)) for kind in cfg.layer_kinds())
    assert port_count == spec_count(RefModel(ref_configs.get("recurrentgemma-9b")).param_specs())
    assert port_count == 10_444_984_320


def test_params_from_jax_carries_the_recurrent_tail():
    """Layers 3 and 4 of the 5-layer variant come from ``tail/tail0_rglru``
    and ``tail/tail1_rglru``; layers 0-2 from index 0 of ``groups``."""
    cfg = dataclasses.replace(recurrent_tail_config(), dtype="float32")
    _, params, port = lm_pair(cfg, seed=12)
    assert [layer.kind for layer in port.layers] == ["rglru", "rglru", "local", "rglru", "rglru"]
    for idx, key in ((3, "tail0_rglru"), (4, "tail1_rglru")):
        for name, want in params["tail"][key].items():
            np.testing.assert_array_equal(getattr(port.layers[idx], name).numpy(), np.asarray(want))
    for idx, key in enumerate(("blk0_rglru", "blk1_rglru", "blk2_local")):
        for name, want in params["groups"][key].items():
            np.testing.assert_array_equal(getattr(port.layers[idx], name).numpy(), np.asarray(want[0]))


def test_extend_cache_passes_recurrent_states_through():
    """Recurrent states keep their shapes and values in new tensors; the
    attention layer's KV buffers grow to min(window, max_seq); decoding on
    the extended cache leaves the prefill cache as it was."""
    model = build("recurrentgemma-9b", smoke=True, device="cpu", seed=2)
    toks = torch.from_numpy(tokens(model.cfg.vocab, 2, 6, seed=3)).long()
    _, cache = model.prefill({"tokens": toks})
    before = [{n: t.clone() for n, t in sub.items()} for sub in cache]
    grown = extend_cache(model, cache, 40)
    for layer, sub, new in zip(model.layers, cache, grown):
        for name, t in sub.items():
            assert new[name] is not t and new[name].data_ptr() != t.data_ptr()
            if layer.kind == "rglru":
                assert torch.equal(new[name], t)
            else:
                assert new[name].shape[1] == model.cfg.window and torch.equal(new[name][:, :6], t)
    assert tuple(grown[0]["h"].shape) == (2, model.cfg.d_model)
    assert tuple(grown[0]["conv"].shape) == (2, 3, model.cfg.d_model)
    model.decode_step(grown, toks[:, :1], 6)
    assert not torch.equal(grown[0]["h"], before[0]["h"])
    for sub, old in zip(cache, before):
        for name, t in sub.items():
            assert torch.equal(t, old[name]), name


def test_params_from_jax_carries_the_expert_weights():
    """Each MoE layer's router (D, E) and expert weights (E, D, F) / (E, F,
    D) come out of ``groups/blk0_attn`` at the layer's index on the leading
    ``n_groups`` axis."""
    cfg = dataclasses.replace(ref_configs.get_smoke("olmoe-1b-7b"), dtype="float32")
    ref, params, port = lm_pair(cfg, seed=9)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    group = params["groups"]["blk0_attn"]
    for idx, layer in enumerate(port.layers):
        for name, shape in (("router", (D, E)), ("wi", (E, D, F)), ("wu", (E, D, F)), ("wd", (E, F, D))):
            got = getattr(layer, name)
            assert tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), np.asarray(group[name][idx]))


def test_training_is_a_later_slice():
    model = build("smollm-360m", smoke=True, device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        model.loss_fn({"tokens": torch.zeros(1, 4, dtype=torch.long)})


def test_configs_are_the_references():
    assert configs.ARCHS == ref_configs.ARCHS
    for arch in configs.ARCHS:
        assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(ref_configs.get(arch))
        assert dataclasses.asdict(configs.get_smoke(arch)) == dataclasses.asdict(
            ref_configs.get_smoke(arch))
