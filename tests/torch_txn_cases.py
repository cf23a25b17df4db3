"""The configurations and comparisons shared by ``test_torch_txn.py``,
``test_torch_txn_checkers.py`` and ``test_torch_kafka.py``: the
transactional workloads over Raft and kafka at test size, each case a
``(workload, model_opts, run_opts)`` triple (``model_opts`` are the
registry's model-selection flags, which the run options repeat); the
tick-by-tick carry comparison; and both runtimes' ``client_step`` on one
hand-made client state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu_torch import convert, harness, runtime, wire
from maelstrom_tpu_torch.models import get_model

from torch_tutorial_cases import CRASH_LINKS_PLAN, JAX_RUN  # noqa: F401

# 200 ticks; partitions in [60, 120), final heal at 170
TXN = dict(node_count=3, concurrency=6, n_instances=8, record_instances=2,
           time_limit=0.2, rate=200.0, latency=5.0, rpc_timeout=1.0,
           nemesis=["partition"], nemesis_interval=0.06, p_loss=0.05,
           recovery_time=0.03, seed=5, telemetry=True, inbox_k=2,
           pool_slots=32, layout="lead")
# the bench's kafka overrides (1 node, no nemesis, 0.25 s RPC timeout),
# 150 ticks
KAFKA = dict(TXN, node_count=1, nemesis=[], rpc_timeout=0.25,
             time_limit=0.15)
CRASH = {"crash_clients": True}

TXN_CASES = {
    "txn-list-append": ("txn-list-append", {}, TXN),
    "txn-rw-register": ("txn-rw-register", {}, TXN),
    # cold restarts: the slab carries list-append's [I, N, 8, 17] kv
    "txn-list-append-crash-links": (
        "txn-list-append", {}, dict(TXN, fault_plan=CRASH_LINKS_PLAN)),
    "txn-list-append-bug-dirty-apply": (
        "txn-list-append-bug-dirty-apply", {}, TXN),
    "txn-rw-register-bug-dirty-apply": (
        "txn-rw-register", {"txn_dirty_apply": True},
        dict(TXN, txn_dirty_apply=True)),
}
KAFKA_CASES = {
    "kafka": ("kafka", {}, KAFKA),
    "kafka-crash-clients": ("kafka", CRASH, dict(KAFKA, **CRASH)),
    "kafka-bug-offset-reuse": ("kafka-bug-offset-reuse", {}, KAFKA),
    "kafka-bug-commit-regression": ("kafka-bug-commit-regression", {},
                                    KAFKA),
}


def models(case):
    """The JAX model and the port's model of a case."""
    workload, mopts, opts = case
    return (jget_model(workload, opts["node_count"], opts=mopts),
            get_model(workload, opts["node_count"], opts=mopts))


def client_step_pair(jmodel, model, opts, reply_types, seed=0):
    """Both runtimes' ``client_step`` on one hand-made client state of
    2 instances x 4 clients at tick 50 (timeout 10 ticks, rate 1):
    client 0 gets a reply of type ``reply_types[i]`` in instance ``i``
    (behind a non-matching row), client 1 an error reply (code 11,
    definite, then 13, indeterminate), client 2 times out and client 3
    is idle and invokes. Returns the JAX and the port outputs, each
    ``(client state, requests, events)`` as numpy arrays."""
    I, C, K, t = 2, 4, 2, 50
    sim = harness.make_sim_config(model, opts)
    jsim = jharness.make_sim_config(jmodel, opts)
    L = sim.net.lanes
    rs = np.random.RandomState(seed)
    op = rs.randint(0, 8, (I, C, model.op_lanes)).astype(np.int32)
    status = np.array([[1, 1, 1, 0]] * I, np.int32)
    msg_id = np.array([[5, 6, 7, -1]] * I, np.int32)
    next_msg_id = np.array([[6, 7, 8, 3]] * I, np.int32)
    invoked = np.array([[45, 45, 30, 0]] * I, np.int32)
    inbox = np.zeros((I, C, K, L), np.int32)
    inbox[:, 0, 0, [wire.VALID, wire.REPLYTO]] = (1, 99)
    inbox[:, 0, 1, wire.VALID] = 1
    inbox[:, 0, 1, wire.REPLYTO] = 5
    inbox[:, 0, 1, wire.TYPE] = reply_types
    inbox[:, 0, 1, wire.BODY:] = rs.randint(-3, 40, (I, L - wire.BODY))
    inbox[:, 1, 0, [wire.VALID, wire.REPLYTO, wire.TYPE]] = (1, 6, 127)
    inbox[:, 1, 0, wire.BODY] = (11, 13)
    inbox[:, 1, 0, wire.BODY + 1:] = rs.randint(0, 9, (I, L - wire.BODY - 1))
    ccfg = dict(n_clients=C, rate=1.0, timeout_ticks=10)
    keys = jax.random.split(jax.random.PRNGKey(seed + 3), I)

    jcs = jruntime.ClientState(*(jnp.asarray(x) for x in (
        status, op, msg_id, next_msg_id, invoked)))
    step = jax.vmap(lambda cs, ib, k: jruntime.client_step(
        jmodel, cs, ib, jnp.int32(t), k, jsim.net,
        jruntime.ClientConfig(**ccfg), None))
    jout = jax.tree.map(np.asarray, step(jcs, jnp.asarray(inbox), keys))

    cs = runtime.ClientState(*(torch.from_numpy(x) for x in (
        status, op, msg_id, next_msg_id, invoked)))
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    with torch.no_grad():
        out = runtime.client_step(model, cs, torch.from_numpy(inbox), t,
                                  tkeys, sim.net,
                                  runtime.ClientConfig(**ccfg), None)
    tout = (type(out[0])(*(x.numpy() for x in out[0])), out[1].numpy(),
            out[2].numpy())
    return jout, tout


def carry_matches_jax_every_tick(name, case):
    """The port's carry and events against the JAX runtime's after
    every tick of a case, and, halfway, the JAX carry handed to the port
    (``convert.carry_from_numpy`` with the model's row type) stepping as
    the port's own carry does; returns the port's final carry."""
    jmodel, model = models(case)
    opts = case[2]
    jsim = jharness.make_sim_config(jmodel, opts)
    params = jmodel.make_params(jsim.net.n_nodes)
    jcarry = jruntime.init_carry(jmodel, jsim, opts["seed"], params)
    jtick = jax.jit(jruntime.make_tick_fn(jmodel, jsim, params))
    sim = harness.make_sim_config(model, opts)
    assert sim.n_ticks == jsim.n_ticks and sim.net.lanes == jsim.net.lanes
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    t_hand = sim.n_ticks // 2
    with torch.no_grad():
        for t in range(-1, sim.n_ticks):
            if t == t_hand:
                handed, _ = tick(convert.carry_from_numpy(
                    jc, type(carry.node_state), "cpu"), t)
            if t >= 0:
                jcarry, ys = jtick(jcarry, jnp.int32(t))
                carry, events = tick(carry, t)
                np.testing.assert_array_equal(
                    np.asarray(ys.events), events.numpy(),
                    err_msg=f"{name}: events at {t}")
            jc = jax.tree.map(np.asarray,
                              jruntime.canonical_carry(jcarry, jsim))
            ref = dict(convert.carry_leaves(jc))
            got = dict(convert.carry_leaves(convert.carry_to_numpy(carry)))
            assert set(got) <= set(ref), set(got) - set(ref)
            for leaf, x in got.items():
                np.testing.assert_array_equal(
                    ref[leaf], x, err_msg=f"{name}: {leaf} after tick {t}")
            if t == t_hand:
                for leaf, x in convert.carry_leaves(
                        convert.carry_to_numpy(handed)):
                    np.testing.assert_array_equal(
                        got[leaf], x, err_msg=f"{name}: {leaf} of the "
                                              f"handed-over tick {t}")
    assert int(carry.stats.sent) > 0
    return carry
