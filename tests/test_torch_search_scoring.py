"""Scoring parity of the PyTorch port against the reference.

The port's ``BatchArena`` and ``ThroughputModel`` compiles must produce the
reference's arrays, and its ``evaluate_batch`` / ``throughput_batch`` (on
the CPU: the fused kernel's plain torch version) must equal the
reference's ``backend="numpy"`` outputs bit for bit — on the §6 suite, the
1000-task flagship case, the padding cases (no task edges, no hard
columns), reconfiguration move arrays, and when fed the reference's own
compiled arrays through ``from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.search import evaluate_batch as ref_evaluate  # noqa: E402
from repro.core.search.throughput import throughput_batch as ref_throughput  # noqa: E402
from repro_torch.core.search import (  # noqa: E402
    BatchArena,
    ThroughputModel,
    evaluate_batch,
    throughput_batch,
)
from repro_torch.core.search.kernels import fused_score_plain  # noqa: E402
from torch_cases import (  # noqa: E402
    SUITE_IDS,
    compile_case,
    random_batch,
    with_moves,
    without_hard_dims,
)

ARENA_ARRAYS = (
    "net", "avail", "hard_demand", "alive", "edges", "adj", "adj_mask", "rack_of",
)


def assert_scores_equal(ref_ba, ref_tm, port_ba, port_tm, batch):
    """Reference numpy backend == port (uploaded to the CPU), all terms."""
    ref = ref_evaluate(ref_ba, batch, backend="numpy", throughput_model=ref_tm)
    out = evaluate_batch(
        port_ba.to("cpu"), batch,
        throughput_model=None if port_tm is None else port_tm.to("cpu"),
    )
    assert np.array_equal(ref.net, out.net.numpy())
    assert np.array_equal(ref.violation, out.violation.numpy())
    assert np.array_equal(ref.dead, out.dead.numpy())
    assert out.dead.dtype == torch.int64
    if ref_tm is not None:
        assert np.array_equal(ref.throughput, out.throughput.numpy())
    return ref


@pytest.mark.parametrize("name", SUITE_IDS + ["flagship", "solo"])
def test_compiled_arrays_equal_reference(name):
    *_, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    assert port_ba.node_ids == ref_ba.node_ids
    assert port_ba.tids == ref_ba.tids
    assert port_ba.hard_dims == ref_ba.hard_dims
    assert port_ba.n_racks == ref_ba.n_racks
    for field in ARENA_ARRAYS:
        assert np.array_equal(getattr(port_ba, field), getattr(ref_ba, field)), field
    up = port_ba.to("cpu")
    for field in ARENA_ARRAYS:
        t = getattr(up, field)
        assert t.dtype in (torch.float64, torch.int64, torch.bool), field
        assert np.array_equal(t.numpy(), getattr(ref_ba, field)), field
    ref_fields, port_fields = dataclasses.asdict(ref_tm), dataclasses.asdict(port_tm)
    assert ref_fields.keys() == port_fields.keys()
    for key, ref_value in ref_fields.items():
        if isinstance(ref_value, np.ndarray):
            assert np.array_equal(port_fields[key], ref_value), key
        else:
            assert port_fields[key] == ref_value, key


@pytest.mark.parametrize("name", SUITE_IDS)
def test_scores_equal_reference_on_suite(name):
    *_, ref_assignment, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    batch = random_batch(ref_ba, 24, seed=7)
    batch[0] = ref_ba.encode(dict(ref_assignment.placements))
    assert_scores_equal(ref_ba, ref_tm, port_ba, port_tm, batch)
    assert_scores_equal(ref_ba, None, port_ba, None, batch)


def test_scores_equal_reference_on_flagship():
    *_, ref_ba, ref_tm = compile_case(R, "flagship")
    *_, port_ba, port_tm = compile_case(P, "flagship")
    assert (ref_ba.n_tasks, ref_ba.n_nodes) == (1000, 256)
    assert_scores_equal(ref_ba, ref_tm, port_ba, port_tm, random_batch(ref_ba, 6, seed=1))


@pytest.mark.parametrize("name", ["solo", "pageload"])
def test_padding_cases_no_edges_and_no_hard_dims(name):
    *_, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    if name == "solo":
        assert ref_ba.edges.shape[0] == 0
    batch = random_batch(ref_ba, 9, seed=3)
    assert_scores_equal(ref_ba, ref_tm, port_ba, port_tm, batch)
    ref = assert_scores_equal(
        without_hard_dims(ref_ba), ref_tm, without_hard_dims(port_ba), port_tm, batch
    )
    assert (ref.violation == 0.0).all()


@pytest.mark.parametrize("name", ["diamond_net", "processing"])
def test_scores_equal_reference_with_move_arrays(name):
    *_, ref_ba, ref_tm = compile_case(R, name)
    *_, port_ba, port_tm = compile_case(P, name)
    batch = random_batch(ref_ba, 16, seed=11)
    ref = assert_scores_equal(
        with_moves(ref_ba, 4), ref_tm, with_moves(port_ba, 4), port_tm, batch
    )
    plain = ref_evaluate(ref_ba, batch, backend="numpy")
    assert (ref.net > plain.net).any()  # the move term is really charged


@pytest.mark.parametrize("name", SUITE_IDS)
def test_port_scores_reference_arrays_via_from_numpy(name):
    """Scoring parity on the reference's own compiled arrays — separates
    scoring parity from compile parity."""
    *_, ref_ba, ref_tm = compile_case(R, name)
    ref_ba = with_moves(ref_ba, 2)
    ba = BatchArena.from_numpy(dataclasses.asdict(ref_ba), device="cpu")
    tm = ThroughputModel.from_numpy(dataclasses.asdict(ref_tm), device="cpu")
    assert dataclasses.asdict(tm.ack) == dataclasses.asdict(ref_tm.ack)
    batch = random_batch(ref_ba, 16, seed=5)
    ref = ref_evaluate(ref_ba, batch, backend="numpy", throughput_model=ref_tm)
    out = evaluate_batch(ba, batch, throughput_model=tm)
    assert np.array_equal(ref.net, out.net.numpy())
    assert np.array_equal(ref.violation, out.violation.numpy())
    assert np.array_equal(ref.dead, out.dead.numpy())
    assert np.array_equal(ref.throughput, out.throughput.numpy())


def test_throughput_batch_and_chunking_equal_reference():
    *_, ref_ba, ref_tm = compile_case(R, "pageload")
    *_, port_ba, port_tm = compile_case(P, "pageload")
    ba, tm = port_ba.to("cpu"), port_tm.to("cpu")
    batch = random_batch(ref_ba, 11, seed=9)
    ref = ref_throughput(ref_ba, ref_tm, batch, backend="numpy")
    assert np.array_equal(ref, throughput_batch(ba, tm, batch).numpy())
    assert np.array_equal(ref, throughput_batch(ba, tm, batch, chunk=3).numpy())
    row = throughput_batch(ba, tm, batch[4])
    assert row.shape == (1,) and row[0].item() == ref[4]
    with pytest.raises(ValueError):
        evaluate_batch(ba, batch, chunk=0)


def test_dead_nodes_counted():
    topology, cluster, assignment, port_ba, _ = compile_case(P, "linear_net", with_tm=False)
    ref_topology, ref_cluster, ref_assignment, ref_ba, _ = compile_case(
        R, "linear_net", with_tm=False
    )
    for c in (cluster, ref_cluster):
        for nid in sorted(c.nodes)[:4]:
            c.fail_node(nid)
    ref_arena = R.PlacementArena(ref_cluster, ref_topology)
    arena = P.PlacementArena(cluster, topology)
    ref_ba = R.BatchArena.from_arena(
        ref_arena, ref_topology, dict(ref_assignment.placements), avail0=ref_arena.snapshot()
    )
    port_ba = P.BatchArena.from_arena(
        arena, topology, dict(assignment.placements), avail0=arena.snapshot()
    )
    dead_nodes = np.flatnonzero(~ref_ba.alive)
    rng = np.random.Generator(np.random.Philox(5))
    batch = dead_nodes[rng.integers(0, dead_nodes.size, size=(13, ref_ba.n_tasks))]
    ref = assert_scores_equal(ref_ba, None, port_ba, None, batch)
    assert (ref.dead == ref_ba.n_tasks).all()


def test_plain_version_whole_batch_matches_chunked_evaluate():
    """The plain version on a whole batch equals the chunked evaluator."""
    *_, port_ba, port_tm = compile_case(P, "star_net")
    ba, tm = port_ba.to("cpu"), port_tm.to("cpu")
    batch = torch.as_tensor(random_batch(port_ba, 10, seed=2))
    whole = fused_score_plain(ba, batch, tm)
    chunked = evaluate_batch(ba, batch, chunk=4, throughput_model=tm)
    for a, b in zip(whole, (chunked.net, chunked.violation, chunked.dead, chunked.throughput)):
        assert torch.equal(a, b)


def test_placement_batch_validation():
    *_, port_ba, _ = compile_case(P, "linear_net", with_tm=False)
    ba = port_ba.to("cpu")
    with pytest.raises(ValueError):
        evaluate_batch(ba, np.zeros((2, ba.n_tasks + 1), dtype=np.int64))
    bad = np.zeros((2, ba.n_tasks), dtype=np.int64)
    bad[1, 0] = ba.n_nodes
    with pytest.raises(ValueError):
        evaluate_batch(ba, bad)
