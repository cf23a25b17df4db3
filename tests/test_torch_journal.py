"""The per-message journal and the NETID lane against the JAX runtime.

With ``journal_instances > 0`` the wire format gains the trailing NETID
lane (``netid`` resolves to on), which the runtime stamps at send time.
For lin-kv (fused Raft), kafka (L = 33), txn-list-append and broadcast
(the legacy handle/tick driver) the port's carry, pool included, must
equal the JAX carry (``runtime.canonical_carry``) after every tick, and
the tick's journal outputs — the journaled instances' sent rows and
inboxes — must be equal too; ``TpuJournal.events()`` and ``.stats()``
then agree. Both harnesses on one journaled run give equal
``results["net"]["journal"]`` blocks and byte-equal ``messages.svg``
files. Tolerance: exact (int32 state, bit-defined draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu import harness as jharness
from maelstrom_tpu.tpu import runtime as jruntime
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu.tpu.journal import TpuJournal as JTpuJournal
from maelstrom_tpu_torch import convert, harness, runtime, wire
from maelstrom_tpu_torch.journal import TpuJournal
from maelstrom_tpu_torch.models import get_model

from torch_mutant_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_mutant_cases import read
from torch_tutorial_cases import BASE, JAX_RUN
from torch_txn_cases import KAFKA, TXN

# test_torch_raft's flagship options at 8 instances and 150 ticks
# (partitions in [50, 100), final heal at 120)
LIN_KV = dict(BASE, inbox_k=1, pool_slots=16, time_limit=0.15)

# workload -> (node count, options, wire format's row width)
CASES = {
    "lin-kv": (3, LIN_KV, 21),
    "kafka": (1, KAFKA, 33),
    "txn-list-append": (3, TXN, 67),
    "broadcast": (3, BASE, 11),
}
J = 2   # journaled instances


@pytest.mark.parametrize("name", list(CASES))
def test_carry_and_journal_match_jax_every_tick(name):
    n, opts, lanes = CASES[name]
    opts = dict(opts, journal_instances=J)
    jmodel, model = jget_model(name, n), get_model(name, n)
    jsim = jharness.make_sim_config(jmodel, opts)
    sim = harness.make_sim_config(model, opts)
    assert sim.net == jsim.net and sim.net.netid is True
    assert sim.net.lanes == lanes and sim.journal_instances == J
    params = jmodel.make_params(jsim.net.n_nodes)
    jcarry = jruntime.init_carry(jmodel, jsim, opts["seed"], params)
    jtick = jax.jit(jruntime.make_tick_fn(jmodel, jsim, params))
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    jsends, jrecvs, sends, recvs = [], [], [], []
    with torch.no_grad():
        for t in range(sim.n_ticks):
            jcarry, ys = jtick(jcarry, jnp.int32(t))
            carry, out = tick(carry, t)
            for field in ("events", "journal_sends", "journal_recvs"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(ys, field)),
                    getattr(out, field).numpy(),
                    err_msg=f"{name}: {field} at tick {t}")
            jc = jax.tree.map(np.asarray,
                              jruntime.canonical_carry(jcarry, jsim))
            ref = dict(convert.carry_leaves(jc))
            got = dict(convert.carry_leaves(convert.carry_to_numpy(carry)))
            assert set(got) <= set(ref), set(got) - set(ref)
            for leaf, x in got.items():
                np.testing.assert_array_equal(
                    ref[leaf], x, err_msg=f"{name}: {leaf} after tick {t}")
            jsends.append(np.asarray(ys.journal_sends))
            jrecvs.append(np.asarray(ys.journal_recvs))
            sends.append(out.journal_sends.numpy())
            recvs.append(out.journal_recvs.numpy())
    # the lane is stamped: every valid sent row carries its send-time id
    s = np.stack(sends)
    M = s.shape[2]
    stamped = s[..., sim.net.netid_lane]
    expect = np.arange(sim.n_ticks)[:, None, None] * M + np.arange(M)
    valid = s[..., wire.VALID] == 1
    assert valid.sum() > 0
    np.testing.assert_array_equal(stamped, np.broadcast_to(expect,
                                                           stamped.shape))
    for inst in range(J):
        jj = JTpuJournal(jmodel, jsim.net, np.stack(jsends),
                         np.stack(jrecvs), instance=inst)
        tj = TpuJournal(model, sim.net, np.stack(sends), np.stack(recvs),
                        instance=inst)
        assert list(tj.events()) == list(jj.events())
        assert tj.stats() == jj.stats()
        assert tj.stats()["all"]["recv-count"] > 0


# the pipelined executor (two chunks) and the single loop
HARNESS_CASES = {
    "lin-kv-pipelined": ("lin-kv", 3, dict(LIN_KV, pipeline="on",
                                           chunk_ticks=75)),
    "echo-single-loop": ("echo", 3, dict(BASE, pipeline="off")),
}


@pytest.mark.parametrize("case", list(HARNESS_CASES))
def test_journal_block_and_messages_svg_match_jax(case, tmp_path):
    name, n, opts = HARNESS_CASES[case]
    opts = dict(opts, journal_instances=1)
    jres = run_tpu_test(jget_model(name, n),
                        dict(opts, **JAX_RUN,
                             store_root=str(tmp_path / "jax")))
    tres = harness.run_torch_test(
        get_model(name, n), dict(opts, store_root=str(tmp_path / "torch")),
        device="cpu")
    assert tres["net"] == jres["net"]
    block = tres["net"]["journal"]
    assert block["instance"] == 0 and block["stats"]["all"]["msg-count"] > 0
    assert set(block) == {"stats", "msgs-per-op", "drops", "instance"}
    svg = read(tres["store-dir"], "messages.svg")
    assert svg == read(jres["store-dir"], "messages.svg")
    assert svg.count(b"<line") > 10


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_journaling_without_netid_is_refused(pkg):
    opts = dict(LIN_KV, journal_instances=1, netid=False)
    make = jharness.make_sim_config if pkg == "jax" \
        else harness.make_sim_config
    get = jget_model if pkg == "jax" else get_model
    with pytest.raises(ValueError, match="journal_instances > 0 needs the "
                       "wire format's NETID pairing lane"):
        make(get("lin-kv", 3), opts)
    # netid=True without a journal widens the rows all the same
    sim = make(get("lin-kv", 3), dict(LIN_KV, netid=True))
    assert sim.net.lanes == 21 and sim.journal_instances == 0
