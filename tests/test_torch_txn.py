"""The transactional workloads of the port against the JAX package,
tick by tick: txn-list-append and txn-rw-register over Raft and their
dirty-apply mutants, and the copied Elle checker.

At test size (8 instances, 200 ticks, partitions and 5% loss;
``torch_txn_cases.py``), and under a crash and links plan whose slab
carries list-append's 2-D kv: the port's carry equals the JAX
``make_tick_fn`` carry after every tick, every leaf, and so do the
recorded events (tolerance 0: int32 state, bit-defined draws). The wide
client-event path equals JAX's ``client_step`` on a reply, an error
reply, a timeout and an invocation. The copied Elle checker gives the
JAX checker's report on hand-made histories that reach each rule, under
four consistency models. Both harnesses and the CLI are in
``test_torch_txn_checkers.py``."""

import numpy as np
import pytest

from torch_txn_cases import (TXN_CASES, carry_matches_jax_every_tick,
                             client_step_pair, models)
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("name", list(TXN_CASES))
def test_carry_matches_jax_every_tick(name):
    carry = carry_matches_jax_every_tick(name, TXN_CASES[name])
    assert int(carry.stats.dropped_partition) > 0
    if "fault_plan" in TXN_CASES[name][2]:
        # the slab holds the list-append kv [I, N, n_keys, 1 + list_cap]
        assert tuple(carry.snapshots["kv"].shape) == (8, 3, 8, 17)


@pytest.mark.parametrize("reply_types", [(21, 0), (21, 21)])
def test_client_step_wide_matches_jax(reply_types):
    """txn-list-append (58 value lanes, 10-lane op rows): a T_TXN_OK
    reply, a reply of another type, error replies, a timeout and an
    invocation give the JAX events, requests and client state."""
    case = TXN_CASES["txn-list-append"]
    jmodel, model = models(case)
    assert model.ev_vals == 58 and model.op_lanes == 10
    (jcs, jreqs, jev), (cs, reqs, ev) = client_step_pair(
        jmodel, model, case[2], reply_types)
    np.testing.assert_array_equal(jev, ev)
    np.testing.assert_array_equal(jreqs, reqs)
    for a, b in zip(jcs, cs):
        np.testing.assert_array_equal(a, b)
    # completion types: ok or info, fail (code 11), info (code 13),
    # timeout info; every client invokes
    assert ev[0, :3, 0, 0].tolist() == [2, 3, 4]
    assert ev[1, 1, 0, 0] == 4 and (ev[:, :, 1, 0] == 1).all()


# --- the copied Elle checker on hand-made histories ------------------------


def _txns(*rows):
    """History records from ``(process, type, micro-ops, time)`` rows."""
    return [{"process": p, "type": typ, "f": "txn", "value": v,
             "index": i, "time": tm}
            for i, (p, typ, v, tm) in enumerate(rows)]


A = lambda k, v: ["append", k, v]
R = lambda k, v=None: ["r", k, v]
W = lambda k, v: ["w", k, v]

LIST_APPEND = {
    "clean": _txns((0, "invoke", [A(1, 1)], 0), (0, "ok", [A(1, 1)], 1),
                   (1, "invoke", [R(1)], 2), (1, "ok", [R(1, [1])], 3),
                   (0, "invoke", [A(1, 2)], 4), (0, "ok", [A(1, 2)], 5),
                   (1, "invoke", [R(1)], 6), (1, "ok", [R(1, [1, 2])], 7)),
    "G0": _txns((0, "invoke", [A(0, 1), A(1, 2)], 0),
                (1, "invoke", [A(1, 1), A(0, 2)], 0),
                (0, "ok", [A(0, 1), A(1, 2)], 5),
                (1, "ok", [A(1, 1), A(0, 2)], 5),
                (2, "invoke", [R(0), R(1)], 6),
                (2, "ok", [R(0, [1, 2]), R(1, [1, 2])], 7)),
    "G1c": _txns((0, "invoke", [A(1, 1), R(2)], 0),
                 (1, "invoke", [A(2, 1), R(1)], 1),
                 (0, "ok", [A(1, 1), R(2, [1])], 2),
                 (1, "ok", [A(2, 1), R(1, [1])], 3)),
    "G-single": _txns((0, "invoke", [A(1, 1), A(2, 1)], 0),
                      (1, "invoke", [R(1), R(2)], 1),
                      (0, "ok", [A(1, 1), A(2, 1)], 2),
                      (1, "ok", [R(1, []), R(2, [1])], 3),
                      (2, "invoke", [R(1)], 4),
                      (2, "ok", [R(1, [1])], 5)),
    "lost-append": _txns((0, "invoke", [A(1, 1)], 0),
                         (0, "ok", [A(1, 1)], 1),
                         (1, "invoke", [R(1)], 2), (1, "ok", [R(1, [])], 3)),
    "incompatible-order": _txns((0, "invoke", [R(1)], 0),
                                (0, "ok", [R(1, [1, 2])], 1),
                                (1, "invoke", [R(1)], 2),
                                (1, "ok", [R(1, [2, 1])], 3)),
    "duplicate-elements": _txns((0, "invoke", [A(1, 1)], 0),
                                (0, "ok", [A(1, 1)], 1),
                                (1, "invoke", [R(1)], 2),
                                (1, "ok", [R(1, [1, 1])], 3)),
    "aborted-read": _txns((0, "invoke", [A(1, 9)], 0),
                          (0, "fail", [A(1, 9)], 1),
                          (1, "invoke", [R(1)], 2),
                          (1, "ok", [R(1, [9])], 3)),
    "realtime-stale": _txns((0, "invoke", [A(1, 1)], 0),
                            (0, "ok", [A(1, 1)], 1),
                            (0, "invoke", [A(1, 2)], 2),
                            (0, "ok", [A(1, 2)], 3),
                            (1, "invoke", [R(1)], 4),
                            (1, "ok", [R(1, [1])], 5),
                            (1, "invoke", [R(1)], 6),
                            (1, "ok", [R(1, [1, 2])], 7)),
}
RW_REGISTER = {
    "clean": _txns((0, "invoke", [W(1, 1)], 0), (0, "ok", [W(1, 1)], 1),
                   (1, "invoke", [R(1)], 2), (1, "ok", [R(1, 1)], 3)),
    "aborted-read": _txns((0, "invoke", [W(1, 5)], 0),
                          (0, "fail", [W(1, 5)], 1),
                          (1, "invoke", [R(1)], 2), (1, "ok", [R(1, 5)], 3)),
    "G1c": _txns((0, "invoke", [W(1, 1), R(2)], 0),
                 (1, "invoke", [W(2, 1), R(1)], 1),
                 (0, "ok", [W(1, 1), R(2, 1)], 2),
                 (1, "ok", [W(2, 1), R(1, 1)], 3)),
    "write-skew": _txns((0, "invoke", [R(1), W(2, 1)], 0),
                        (1, "invoke", [R(2), W(1, 1)], 0),
                        (0, "ok", [R(1, None), W(2, 1)], 5),
                        (1, "ok", [R(2, None), W(1, 1)], 5)),
}
MODELS = ("read-uncommitted", "read-committed", "serializable",
          "strict-serializable")


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", list(LIST_APPEND))
def test_list_append_checker_matches_jax(name, model):
    from maelstrom_tpu.checkers.elle import check_list_append as jcheck
    from maelstrom_tpu_torch.checkers.elle import check_list_append
    h = LIST_APPEND[name]
    got = check_list_append(h, model)
    assert got == jcheck(h, model)
    if model == "strict-serializable":
        assert got["valid?"] is (name == "clean"), got
        kind = {"aborted-read": "G1a", "duplicate-elements":
                "incompatible-order", "realtime-stale": None}.get(name, name)
        if kind is not None and name != "clean":
            assert kind in got["anomaly-types"], got["anomaly-types"]


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("name", list(RW_REGISTER))
def test_rw_register_checker_matches_jax(name, model):
    from maelstrom_tpu.checkers.elle import check_rw_register as jcheck
    from maelstrom_tpu_torch.checkers.elle import check_rw_register
    h = RW_REGISTER[name]
    got = check_rw_register(h, model)
    assert got == jcheck(h, model)
    if model == "strict-serializable":
        assert got["valid?"] is (name == "clean"), got
