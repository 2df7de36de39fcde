"""The CUDA ``fused_score`` kernel on the card.

A CUDA kernel has no interpret mode, so these tests need the card: they
skip without one and run there with ``python -m pytest -m cuda
tests/test_torch_fused_score_cuda.py``.  On the card the kernel must equal
its plain torch version (``torch.equal``) and the reference's numpy backend
(``np.array_equal``), and the search must give the CPU's placements.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.search import evaluate_batch as ref_evaluate  # noqa: E402
from repro_torch.core.search.kernels import (  # noqa: E402
    fused_inputs,
    fused_score,
    fused_score_plain,
)
from torch_cases import (  # noqa: E402
    SUITE_IDS,
    cluster_of,
    compile_case,
    random_batch,
    topology_of,
    with_moves,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("name", SUITE_IDS + ["solo", "flagship"])
def test_kernel_equals_plain_and_reference(card, name):
    *_, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    ref_ba, port_ba = with_moves(ref_ba, 3), with_moves(port_ba, 3)
    batch = random_batch(ref_ba, 37, seed=4)
    ref = ref_evaluate(ref_ba, batch, backend="numpy", throughput_model=ref_tm)
    ba, tm = port_ba.to(card), port_tm.to(card)
    Pb = torch.as_tensor(batch, device=card)
    before = fused_score.launches
    got = fused_score(fused_inputs(ba, tm), Pb)
    assert fused_score.launches == before + 1
    want = fused_score_plain(ba, Pb, tm)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, r in zip(got, (ref.net, ref.violation, ref.dead, ref.throughput)):
        assert np.array_equal(g.cpu().numpy(), r)


def test_kernel_rejects_a_cpu_arena_with_a_card_batch(card):
    *_, port_ba, _ = compile_case(P, "linear_net", with_tm=False)
    inputs = fused_inputs(port_ba.to("cpu"))
    with pytest.raises(ValueError):
        fused_score(inputs, torch.zeros(2, port_ba.n_tasks, dtype=torch.int64, device=card))


@pytest.mark.parametrize("objective", ["netcost", "throughput"])
@pytest.mark.parametrize("name", ["pageload", "star_cpu"])
def test_search_on_card_equals_cpu(card, name, objective):
    kw = dict(n_chains=16, steps=150, seed=2, objective=objective)
    out = {}
    for device in ("cpu", "cuda"):
        topology, cluster = topology_of(P, name), cluster_of(P, name)
        out[device] = P.get_scheduler("rstorm-search", device=device, **kw).schedule(
            topology, cluster, commit=False
        ).placements
    assert out["cpu"] == out["cuda"]
