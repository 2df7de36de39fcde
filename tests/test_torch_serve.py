"""The port's ServingEngine against the reference's on the CPU.

Same float32 smoke model (the reference's seeded parameters carried over
with ``params_from_jax``), same requests: the generated token lists are
equal, for dense attention models, an MoE one and a hybrid recurrent one.
Requests finish at different steps, so later ones are admitted
while other slots are decoding — the admission pass then overwrites those
slots' cache rows, a reference behaviour the port keeps.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import configs as ref_configs  # noqa: E402
from repro.serve import Request as RefRequest, ServingEngine as RefEngine  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve import Request, ServingEngine  # noqa: E402
from torch_cases import lm_pair  # noqa: E402


def requests(cls, vocab, specs, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid, rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=new)
            for rid, (n, new) in enumerate(specs)]


@pytest.mark.parametrize("arch,slots,max_seq,specs", [
    # Three slots, five requests: the fourth and fifth are admitted while
    # others decode.
    ("qwen3-0.6b", 3, 32, [(5, 3), (3, 7), (8, 2), (4, 5), (6, 4)]),
    # Requests stopped by max_seq (pos reaches max_seq - 1 first).
    ("smollm-360m", 2, 12, [(6, 9), (2, 3), (7, 8)]),
    # MoE FFNs: every decode step routes all slots, idle ones included
    # (token 0), through the experts.
    ("olmoe-1b-7b", 3, 32, [(5, 3), (3, 7), (8, 2), (4, 5), (6, 4)]),
    # RG-LRU layers: admission's token 0 also advances every other slot's
    # recurrent state, as in the reference.
    ("recurrentgemma-9b", 3, 32, [(5, 3), (3, 7), (8, 2), (4, 5), (6, 4)]),
])
def test_engine_tokens_match_reference(arch, slots, max_seq, specs):
    cfg = dataclasses.replace(ref_configs.get_smoke(arch), dtype="float32")
    ref, params, port = lm_pair(cfg, seed=11)
    want = RefEngine(ref, params, batch_slots=slots, max_seq=max_seq).run(
        requests(RefRequest, cfg.vocab, specs, seed=12))
    engine = ServingEngine(port, batch_slots=slots, max_seq=max_seq)
    got = engine.run(requests(Request, cfg.vocab, specs, seed=12))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.done for r in got) and all(r.output for r in got)
    assert engine.steps > 0


def test_engine_needs_the_models_device():
    cfg = dataclasses.replace(ref_configs.get_smoke("qwen3-0.6b"), dtype="float32")
    _, _, port = lm_pair(cfg)
    engine = ServingEngine(port, batch_slots=2, max_seq=16)
    assert engine.device == port.device == engine.cache[0]["k"].device
    assert engine.cache[0]["k"].shape == (2, 16, cfg.n_kv_heads, cfg.head_dim)
    with pytest.raises(ValueError, match="use 'cuda' or 'cpu'"):
        Model(port.cfg, device="meta")
