"""The tutorial workloads of the port against the JAX runtime, tick by
tick: echo, unique-ids, broadcast, g-set, g-counter and pn-counter on
the legacy handle/tick node driver.

For each workload at test size (8 instances, 150 ticks, partitions and
5% loss), the 25-node tree4 broadcast of the guide (4 instances, 200
ticks, 256 pool slots, inbox_k 8) and cold restarts under a crash and
links plan (g-set, pn-counter): the port's carry equals the JAX
``make_tick_fn`` carry (lead layout, through ``canonical_carry``) after
every tick, every leaf, and so do the recorded events. Tolerance 0: the
state is int32 and the draws are bit-defined. Also: the topology copy
against the JAX one. The same cases through both harnesses, the
checkers, the CLI and the import rule are in
``test_torch_tutorial_checkers.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import convert, harness, runtime
from maelstrom_tpu_torch.models import get_model

from torch_tutorial_cases import CASES


def _leaves(carry):
    return dict(convert.carry_leaves(carry))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    workload, topology, opts = CASES[request.param]
    jmodel = jget_model(workload, opts["node_count"], topology)
    model = get_model(workload, opts["node_count"], topology)
    return request.param, jmodel, model, opts


def test_carry_matches_jax_every_tick(case):
    name, jmodel, model, opts = case
    jsim = jharness.make_sim_config(jmodel, opts)
    params = jmodel.make_params(jsim.net.n_nodes)
    jcarry = jruntime.init_carry(jmodel, jsim, opts["seed"], params)
    jtick = jax.jit(jruntime.make_tick_fn(jmodel, jsim, params))
    sim = harness.make_sim_config(model, opts)
    assert sim.n_ticks == jsim.n_ticks and sim.net.lanes == jsim.net.lanes
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    with torch.no_grad():
        for t in range(-1, sim.n_ticks):
            if t >= 0:
                jcarry, ys = jtick(jcarry, jnp.int32(t))
                carry, events = tick(carry, t)
                np.testing.assert_array_equal(
                    np.asarray(ys.events), events.numpy(),
                    err_msg=f"{name}: events at {t}")
            ref = _leaves(jax.tree.map(
                np.asarray, jruntime.canonical_carry(jcarry, jsim)))
            got = _leaves(convert.carry_to_numpy(carry))
            assert set(got) <= set(ref), set(got) - set(ref)
            for leaf, x in got.items():
                np.testing.assert_array_equal(
                    ref[leaf], x, err_msg=f"{name}: {leaf} after tick {t}")
    assert int(carry.stats.sent) > 0
    # partitions cut server links only: the gossip workloads cross them
    assert (int(carry.stats.dropped_partition) > 0) == (model.tick_out > 0)
    if "fault_plan" in opts:
        assert "carry.snapshots" in got


@pytest.mark.parametrize("name", ["line", "grid", "total", "tree", "tree2",
                                  "tree3", "tree4"])
@pytest.mark.parametrize("n", [1, 2, 5, 25])
def test_topology_matches_jax(name, n):
    from maelstrom_tpu.models.crdt import adjacency as jadjacency
    from maelstrom_tpu.utils.ids import node_names as jnode_names
    from maelstrom_tpu.utils.ids import sort_ids as jsort_ids
    from maelstrom_tpu.workloads.topology import make_topology
    from maelstrom_tpu_torch import topology
    names = topology.node_names(n)
    assert names == jnode_names(n)
    assert topology.make_topology(name, names) == make_topology(name, names)
    np.testing.assert_array_equal(topology.adjacency(name, n),
                                  np.asarray(jadjacency(name, n)))
    shuffled = names[::-1] + ["n10", "c2", "c10"]
    assert topology.sort_ids(shuffled) == jsort_ids(shuffled)

