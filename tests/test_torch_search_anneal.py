"""Annealing parity of the PyTorch port against the reference.

``repro_torch``'s ``BatchAnnealer`` (an eager torch loop on the CPU here)
must walk exactly the chains of the reference's
``BatchAnnealer(backend="numpy")`` for both objectives, whatever the
reference's ``multi_swap`` (its proposals per fused scan element; the port's
eager loop applies them one at a time) — final placements compared with
``np.array_equal``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.search import BatchAnnealer as RefAnnealer  # noqa: E402
from repro_torch.core.search import BatchAnnealer, SearchScheduler  # noqa: E402
from torch_cases import (  # noqa: E402
    SUITE_IDS,
    compile_case,
    random_batch,
    with_moves,
)


def anneal_both(name, objective, multi_swap, steps=150, n_chains=8, moves=False):
    *_, ref_assignment, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    if moves:
        ref_ba, port_ba = with_moves(ref_ba, 6), with_moves(port_ba, 6)
    P0 = random_batch(ref_ba, n_chains, seed=9)
    P0[0] = ref_ba.encode(dict(ref_assignment.placements))
    ref = RefAnnealer(ref_ba, backend="numpy").run(
        P0, steps, seed=13, tm=ref_tm, objective=objective, multi_swap=multi_swap
    )
    out = BatchAnnealer(port_ba.to("cpu")).run(
        P0, steps, seed=13, tm=port_tm.to("cpu"), objective=objective
    )
    return P0, ref, out


@pytest.mark.parametrize("multi_swap", [1, 8])
@pytest.mark.parametrize("objective", ["netcost", "throughput"])
@pytest.mark.parametrize("name", SUITE_IDS)
def test_chains_equal_reference(name, objective, multi_swap):
    P0, ref, out = anneal_both(name, objective, multi_swap)
    assert out.dtype == torch.int64 and out.shape == ref.shape
    assert np.array_equal(ref, out.numpy())
    assert not np.array_equal(ref, P0)  # the chains really moved


@pytest.mark.parametrize("objective", ["netcost", "throughput"])
def test_chains_equal_reference_with_move_arrays(objective):
    _, ref, out = anneal_both("diamond_net", objective, 8, moves=True)
    assert np.array_equal(ref, out.numpy())


@pytest.mark.parametrize("objective", ["netcost", "throughput"])
def test_chains_equal_reference_on_flagship(objective):
    _, ref, out = anneal_both("flagship", objective, 8, steps=50, n_chains=16)
    assert np.array_equal(ref, out.numpy())


def test_trivial_arena_returns_seed_and_validation():
    *_, port_ba, port_tm = compile_case(P, "solo")
    ba = port_ba.to("cpu")
    P0 = np.zeros((3, ba.n_tasks), dtype=np.int64)
    annealer = BatchAnnealer(ba)
    with pytest.raises(ValueError):
        annealer.run(P0, 10, 0, objective="throughput")
    with pytest.raises(ValueError):
        annealer.run(P0, 10, 0, objective="latency")
    with pytest.raises(ValueError):
        SearchScheduler(multi_swap=0, device="cpu")
    # No edges and hard columns still leave something to improve: compare.
    *_, ref_ba, _ = compile_case(R, "solo")
    ref = RefAnnealer(ref_ba, backend="numpy").run(P0, 40, seed=1)
    assert np.array_equal(ref, annealer.run(P0, 40, seed=1).numpy())
