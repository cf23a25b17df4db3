"""The port's lin-kv Raft fleet against the JAX runtime, tick by tick.

The flagship configuration (3 nodes, 6 clients, inbox_k=1, 16 pool
slots, exponential latency, 5% loss, the random-halves partition
nemesis, telemetry on) at test size: the port's carry must equal the
JAX ``make_tick_fn`` carry (lead layout) at every tick, and a mid-run
JAX carry handed over through ``convert.py`` must continue identically.
Tolerance 0: the state is int32 and the draws are bit-defined."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.models.raft import RaftModel as JRaftModel
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import convert, runtime
from maelstrom_tpu_torch import harness as tharness
from maelstrom_tpu_torch.models.raft import RaftModel, RaftRow

from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# partitions at ticks [100, 200), final heal at 250, final reads at 275
OPTS = dict(node_count=3, concurrency=6, n_instances=64, record_instances=4,
            time_limit=0.3, rate=200.0, latency=5.0, rpc_timeout=1.0,
            nemesis=["partition"], nemesis_interval=0.1, p_loss=0.05,
            recovery_time=0.05, seed=7, telemetry=True, inbox_k=1,
            pool_slots=16, layout="lead")
MODEL_KW = dict(n_nodes_hint=3, log_cap=64, heartbeat=8)


def _leaves(prefix, tup):
    for f in tup._fields:
        yield f"{prefix}.{f}", getattr(tup, f)


def assert_carry_equal(jcarry, tcarry, where=""):
    """Every field of the JAX carry equals the port's, bit for bit."""
    j = jax.tree.map(np.asarray, jcarry)
    t = convert.carry_to_numpy(tcarry)
    pairs = [("pool", j.pool, t.pool), ("violations", j.violations,
                                        t.violations),
             ("key", j.key, t.key)]
    for group in ("node_state", "client_state", "stats", "telemetry"):
        jt, tt = getattr(j, group), getattr(t, group)
        for (name, tv) in _leaves(group, tt):
            pairs.append((name, getattr(jt, name.split(".")[1]), tv))
    for name, a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{name} differs {where}")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trajectory: carry and events after every tick."""
    model = JRaftModel(**MODEL_KW)
    sim = jharness.make_sim_config(model, OPTS)
    carry = jruntime.init_carry(model, sim, OPTS["seed"], None)
    tick = jax.jit(jruntime.make_tick_fn(model, sim, None))
    carries, events = [carry], []
    for t in range(sim.n_ticks):
        carry, ys = tick(carry, jnp.int32(t))
        carries.append(jax.tree.map(np.asarray, carry))
        events.append(np.asarray(ys.events))
    return sim, carries, events


def _port_setup():
    model = RaftModel(**MODEL_KW)
    sim = tharness.make_sim_config(model, OPTS)
    return model, sim


def test_config_matches_jax(jax_run):
    jsim = jax_run[0]
    _, sim = _port_setup()
    assert sim.n_ticks == jsim.n_ticks >= 200
    for f in sim.net._fields:
        assert getattr(sim.net, f) == getattr(jsim.net, f), f
    assert tuple(sim.client) == tuple(jsim.client)
    assert tuple(sim.telemetry) == tuple(jsim.telemetry)
    for f in runtime.NemesisConfig._fields:
        assert getattr(sim.nemesis, f) == getattr(jsim.nemesis, f), f


def test_init_carry_matches_jax(jax_run):
    model, sim = _port_setup()
    carry = runtime.init_carry(model, sim, OPTS["seed"], "cpu")
    assert_carry_equal(jax_run[1][0], carry, "at init")


def test_carry_matches_jax_every_tick(jax_run):
    _, jcarries, jevents = jax_run
    model, sim = _port_setup()
    carry = runtime.init_carry(model, sim, OPTS["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    saw_partition = saw_commit = False
    with torch.no_grad():
        for t in range(sim.n_ticks):
            carry, out = tick(carry, t)
            assert_carry_equal(jcarries[t + 1], carry, f"after tick {t}")
            np.testing.assert_array_equal(jevents[t], out.events.numpy(),
                                          err_msg=f"events at tick {t}")
            saw_partition |= bool(carry.stats.dropped_partition > 0)
            saw_commit |= bool((carry.node_state.commit_idx > 0).any())
    # the run exercised partitions, loss and replication
    assert saw_partition and saw_commit
    assert int(carry.stats.dropped_loss) > 0


@pytest.mark.parametrize("t_hand", [120, 260])
def test_handoff_from_jax_carry(jax_run, t_hand):
    """A JAX carry after tick t_hand - 1 continues in the port as tick
    t_hand, equal to JAX's own tick t_hand."""
    _, jcarries, _ = jax_run
    model, sim = _port_setup()
    carry = convert.carry_from_numpy(jcarries[t_hand], RaftRow, "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    with torch.no_grad():
        carry, _ = tick(carry, t_hand)
    assert_carry_equal(jcarries[t_hand + 1], carry,
                       f"after handed-over tick {t_hand}")


def test_carry_round_trip(jax_run):
    jc = jax_run[1][50]
    back = convert.carry_to_numpy(
        convert.carry_from_numpy(jc, RaftRow, "cpu"))
    assert back.key.dtype == np.uint32
    np.testing.assert_array_equal(back.key, jc.key)
    np.testing.assert_array_equal(back.pool, jc.pool)


@pytest.mark.parametrize("kind", ["random-halves", "scripted"])
def test_partition_matrix_matches_jax(kind):
    """Both ported nemesis kinds against the JAX partition_matrix, over
    heal and partition phases and the final heal."""
    _, sim = _port_setup()
    schedule = ((30, ((0, 1), (1, 0), (2, 5))), (60, ((1, 2),)))
    nem = runtime.NemesisConfig(enabled=True, interval=20, kind=kind,
                                stop_tick=90, schedule=schedule)
    jnem = jruntime.NemesisConfig(enabled=True, interval=20, kind=kind,
                                  stop_tick=90, schedule=schedule)
    jsim = jharness.make_sim_config(JRaftModel(**MODEL_KW), OPTS)
    master = jax.random.PRNGKey(11)
    ids = jnp.arange(16, dtype=jnp.int32)
    jkeys = jruntime._instance_keys(master, jruntime._RNG_NEMESIS, ids)
    tkeys = torch.from_numpy(np.asarray(jkeys).astype(np.int64))
    active = 0
    for t in (0, 25, 29, 30, 45, 59, 60, 75, 89, 90, 95):
        ref = np.asarray(jax.vmap(lambda k: jruntime.partition_matrix(
            jnem, jsim.net, jnp.int32(t), k))(jkeys))
        got = runtime.partition_matrix(nem, sim.net, t, tkeys).numpy()
        np.testing.assert_array_equal(ref, got, err_msg=f"{kind} t={t}")
        active += int(got.any())
    assert active >= 3
