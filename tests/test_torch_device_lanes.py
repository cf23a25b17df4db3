"""The device verdict lanes of the port (``checkers/device_summary.py`` and
each model's ``summary_step``) against the JAX package's, live.

- Each model's batched ``summary_step`` and the whole ``update_summary``
  equal the JAX functions vmapped over the same instances, on states
  drawn from a seed with numpy over the full int32 range (the rolling
  hashes overflow and must wrap as XLA's int32 does), with the Raft
  commit indices tied between nodes whose logs differ (the reference
  node is the first maximal one in both) and counters at the edge of
  int32.
- ``prefix_hash``, ``fold_frontier`` and ``stale_read_window`` equal
  JAX's on such inputs.
- With ``check_mode="device"`` the port's whole carry, ``check_summary``
  included, equals JAX's ``canonical_carry`` after every tick for
  lin-kv, kafka, g-set and pn-counter at the JAX lane tests' options
  (``tests/test_device_check.py`` ``BASE_OPTS``) cut to 150 ticks.

Tolerance: exact (int32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.checkers import device_summary as jds
from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.models.kafka import KafkaRow as JKafkaRow
from maelstrom_tpu.models.raft import RaftRow as JRaftRow
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.checkers import device_summary as ds
from maelstrom_tpu_torch.models import get_model

from test_device_check import BASE_OPTS
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_txn_cases import carry_matches_jax_every_tick

I = 64
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _i32(rs, shape, lo=I32_MIN, hi=I32_MAX):
    return rs.randint(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _opts(workload):
    opts = dict(BASE_OPTS, layout="lead", check_mode="device")
    if workload == "kafka":
        opts.update(node_count=1, nemesis=[], nemesis_interval=0.5)
    return opts


def _raft_state(rs, model, n):
    """A RaftRow of numpy leaves [I, N, ...]: full-range log terms and
    bodies, commit indices tied at the max between two nodes (with
    different logs) in half the instances, sticky witnesses and
    applied-past-log-end rows in a few."""
    keys = torch.zeros((I, n, 2), dtype=torch.int64)
    st = {f: x.numpy().copy() for f, x in
          zip(model.init_state(n, keys)._fields,
              model.init_state(n, keys))}
    cap = model.log_cap
    st["log_term"] = _i32(rs, st["log_term"].shape)
    st["log_body"] = _i32(rs, st["log_body"].shape)
    commit = rs.randint(0, cap + 1, size=(I, n)).astype(np.int32)
    tie = rs.rand(I) < 0.5
    top = commit.max(axis=1)
    commit[tie, 0] = top[tie]
    commit[tie, n - 1] = top[tie]
    st["commit_idx"] = commit
    st["log_len"] = rs.randint(0, cap + 1, size=(I, n)).astype(np.int32)
    st["last_applied"] = rs.randint(0, cap + 1, size=(I, n)).astype(
        np.int32)
    st["truncated_committed"] = (rs.rand(I, n) < 0.05).astype(
        st["truncated_committed"].dtype)
    return st


def _state(rs, workload, model, n):
    if workload in ("lin-kv", "txn-list-append"):
        return _raft_state(rs, model, n)
    if workload == "kafka":
        keys = torch.zeros((I, n, 2), dtype=torch.int64)
        row = model.init_state(n, keys)
        st = {f: x.numpy().copy() for f, x in zip(row._fields, row)}
        cap = model.log_cap
        st["log_vals"] = _i32(rs, st["log_vals"].shape)
        st["log_len"] = rs.randint(0, cap + 1, size=st["log_len"].shape
                                   ).astype(np.int32)
        st["committed"] = rs.randint(-1, cap + 1,
                                     size=st["committed"].shape
                                     ).astype(np.int32)
        return st
    if workload in ("g-set", "broadcast"):
        words = _i32(rs, (I, n, 2))
        settled = rs.rand(I) < 0.3
        words[settled] = words[settled, :1]
        return words
    if workload in ("pn-counter", "g-counter"):
        table = rs.randint(0, 40, size=(I, n, n, 2)).astype(np.int32)
        diag = np.arange(n)
        # own entries at least every view's in most instances
        table[:, diag, diag] = table.max(axis=1)[:, diag] + (
            rs.rand(I, n, 2) < 0.9)
        return table
    return np.zeros((I, n), np.int32)       # echo: the identity hook


def _summ(rs):
    summ = rs.randint(0, 64, size=(I, ds.N_LANES)).astype(np.int32)
    summ[:, ds.L_FLAGS] = rs.randint(0, 8, size=I)
    summ[:, ds.L_SCRATCH] = _i32(rs, (I,), 0, 1 << 31)
    # availability counters at the edge of int32: the twins wrap
    summ[: I // 2, ds.L_OK:ds.L_SCRATCH] = I32_MAX - rs.randint(0, 3)
    return summ


def _events(rs, C, V):
    ev = np.zeros((I, C, 2, 2 + V), np.int32)
    ev[..., 0] = rs.randint(0, 5, size=(I, C, 2))
    ev[..., 1] = rs.randint(1, 4, size=(I, C, 2))      # f: add/read/...
    ev[..., 2:] = rs.randint(-5, 40, size=(I, C, 2, V))
    return ev


def _as_jax(st, jrow_type):
    if isinstance(st, dict):
        return jrow_type(**{f: jnp.asarray(st[f]) for f in jrow_type._fields})
    return jnp.asarray(st)


def _as_torch(st, row_type):
    if isinstance(st, dict):
        return row_type(**{f: torch.from_numpy(st[f])
                           for f in row_type._fields})
    return torch.from_numpy(st)


JAX_ROWS = {"RaftRow": JRaftRow, "KafkaRow": JKafkaRow}
SUMMARY_MODELS = ["lin-kv", "txn-list-append", "kafka", "g-set",
                  "broadcast", "pn-counter", "g-counter", "echo"]


@pytest.mark.parametrize("workload", SUMMARY_MODELS)
def test_summary_step_matches_jax(workload):
    """The batched ``summary_step`` and ``update_summary`` equal JAX's
    vmapped per-instance functions on full-range int32 inputs."""
    opts = _opts(workload)
    n = opts["node_count"]
    jmodel = jget_model(workload, n)
    model = get_model(workload, n)
    jsim = jharness.make_sim_config(jmodel, opts)
    sim = harness.make_sim_config(model, opts)
    params = jmodel.make_params(n)
    rs = np.random.RandomState(11)
    st = _state(rs, workload, model, n)
    summ = _summ(rs)
    ev = _events(rs, sim.client.n_clients, model.ev_vals)
    n_sent = _i32(rs, (I,), 0, 1 << 20)
    n_del = _i32(rs, (I,), 0, 1 << 20)
    probe = model.init_state(n, torch.zeros((1, n, 2), dtype=torch.int64))
    row_type = type(probe) if hasattr(probe, "_fields") else None
    jrow_type = JAX_ROWS.get(getattr(row_type, "__name__", None))
    jst = _as_jax(st, jrow_type)
    tst = _as_torch(st, row_type)

    step = jax.vmap(lambda s, x, e: jmodel.summary_step(
        s, x, e, jsim.net, params))
    want = np.asarray(step(jnp.asarray(summ), jst, jnp.asarray(ev)))
    got = model.summary_step(torch.from_numpy(summ), tst,
                             torch.from_numpy(ev), sim.net).numpy()
    np.testing.assert_array_equal(got, want, err_msg=workload)

    want = np.asarray(jds.update_summary(
        jmodel, jnp.asarray(summ), jst, jnp.asarray(ev),
        jnp.asarray(n_sent), jnp.asarray(n_del), jsim.net, params))
    got = ds.update_summary(model, torch.from_numpy(summ), tst,
                            torch.from_numpy(ev), torch.from_numpy(n_sent),
                            torch.from_numpy(n_del), sim.net).numpy()
    np.testing.assert_array_equal(got, want, err_msg=workload)
    if workload != "echo":
        # the inputs exercise the flags the lanes raise
        assert (want[:, ds.L_FLAGS] != summ[:, ds.L_FLAGS]).any()
    if workload in ("lin-kv", "txn-list-append"):
        # tied maxima between nodes whose logs differ: the reference is
        # the first maximal node, in both
        commit = st["commit_idx"]
        assert ((commit == commit.max(axis=1, keepdims=True)).sum(axis=1)
                >= 2).sum() >= I // 4


def test_lane_primitives_match_jax():
    """``prefix_hash`` (full-range terms and bodies: the products and the
    sum overflow), ``fold_frontier`` and ``stale_read_window`` equal the
    JAX functions vmapped over the instances."""
    rs = np.random.RandomState(5)
    LOGN, E = 96, 6
    terms = _i32(rs, (I, LOGN))
    bodies = _i32(rs, (I, LOGN, E))
    mask = rs.rand(I, LOGN) < 0.7
    want = np.asarray(jax.vmap(jds.prefix_hash)(
        jnp.asarray(terms), jnp.asarray(bodies), jnp.asarray(mask)))
    got = ds.prefix_hash(torch.from_numpy(terms), torch.from_numpy(bodies),
                         torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)

    summ = _summ(rs)
    frontier = rs.randint(0, 64, size=I).astype(np.int32)
    h = _i32(rs, (I,))
    div = rs.rand(I) < 0.3
    flag = rs.rand(I) < 0.3
    want = np.asarray(jax.vmap(jds.fold_frontier)(
        jnp.asarray(summ), jnp.asarray(frontier), jnp.asarray(h),
        jnp.asarray(div), jnp.asarray(flag)))
    got = ds.fold_frontier(torch.from_numpy(summ),
                           torch.from_numpy(frontier), torch.from_numpy(h),
                           torch.from_numpy(div),
                           torch.from_numpy(flag)).numpy()
    np.testing.assert_array_equal(got, want)

    ev = _events(rs, 4, 4)
    unsettled = rs.rand(I) < 0.5
    js, jstale = jax.vmap(lambda s, e, u: jds.stale_read_window(
        s, e, u, 2))(jnp.asarray(summ), jnp.asarray(ev),
                     jnp.asarray(unsettled))
    ts, tstale = ds.stale_read_window(torch.from_numpy(summ),
                                      torch.from_numpy(ev),
                                      torch.from_numpy(unsettled), 2)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tstale.numpy(), np.asarray(jstale))
    assert ds.summary_bytes_per_tick(4096) == \
        jds.summary_bytes_per_tick(4096)


# 150 ticks: partitions every 50 ticks, healed at tick 50 of the recovery
CARRY_CASES = ["lin-kv", "kafka", "g-set", "pn-counter"]


@pytest.mark.parametrize("workload", CARRY_CASES)
def test_check_summary_carry_every_tick(workload):
    """With the lanes on, the whole carry (``check_summary`` included)
    equals JAX's after every tick."""
    opts = dict(_opts(workload), time_limit=0.15, recovery_time=0.05)
    carry = carry_matches_jax_every_tick(workload, (workload, {}, opts))
    summ = carry.check_summary.numpy()
    assert summ.shape == (opts["n_instances"], ds.N_LANES)
    # the availability twins counted completions
    assert summ[:, ds.L_OK].sum() > 0
