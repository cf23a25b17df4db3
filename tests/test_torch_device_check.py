"""The port's verdict routing (``check_mode`` device and both) against the
JAX harness's, live, on the JAX lane tests' tier-1 workloads
(``tests/test_device_check.py`` ``TIER1_MATRIX``: the Raft, g-set,
kafka and counter lanes and one identity hook) in the lead layout, at
its ``BASE_OPTS`` cut to 200 ticks.

For each workload both harnesses run in ``device`` and in ``both``
mode: the results blocks (verdict, every per-instance verdict with the
synthesized ``checked-by: device-summary`` ones, ``check`` with the
flagged ids, farm instances, load fraction and the ``device-vs-farm``
audit, invariants, network counters) are equal; the port's ``both``
audit is complete; and within the port, device mode's ``valid?`` equals
``both`` mode's for every instance, a flagged instance's verdict byte
for byte. ``both`` checks every recorded instance, as ``farm`` does.

Tolerance: exact."""

import pytest

from maelstrom_tpu.models import get_model as jget_model
from maelstrom_tpu.tpu.harness import run_tpu_test
from maelstrom_tpu_torch import harness
from maelstrom_tpu_torch.models import get_model

from test_device_check import BASE_OPTS, TIER1_MATRIX
from torch_tutorial_cases import JAX_RUN
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

# the JAX results' keys the port must equal
COMPARED = ("valid?", "invariants", "instance-count", "checked-instances",
            "valid-instances", "checker-errors", "instances", "net",
            "check")


def workload_opts(workload):
    opts = dict(BASE_OPTS, layout="lead", time_limit=0.2,
                recovery_time=0.05)
    if workload == "kafka":
        # the JAX tests' kafka shape: one node, no nemesis
        opts.update(node_count=1, nemesis=[], nemesis_interval=0.5)
    return opts


def run_pair(workload, opts, mk=None):
    """The JAX and the port harness on one configuration (serial
    checks on both sides)."""
    n = opts["node_count"]
    jmodel = mk(jax=True) if mk else jget_model(workload, n)
    model = mk(jax=False) if mk else get_model(workload, n)
    jres = run_tpu_test(jmodel, dict(opts, **JAX_RUN))
    tres = harness.run_torch_test(model, dict(opts, check_workers=0),
                                  device="cpu")
    return jres, tres


def assert_same(jres, tres, name):
    jkeys = [k for k in jres if k in COMPARED]
    assert [k for k in tres if k in COMPARED] == jkeys, name
    for k in jkeys:
        assert tres[k] == jres[k], f"{name}: {k} differs"


@pytest.mark.parametrize("workload", [w for w, _ in TIER1_MATRIX])
def test_device_and_both_modes_match_jax(workload):
    opts = workload_opts(workload)
    dev_j, dev = run_pair(workload, dict(opts, check_mode="device"))
    both_j, both = run_pair(workload, dict(opts, check_mode="both"))
    assert_same(dev_j, dev, f"{workload} device")
    assert_same(both_j, both, f"{workload} both")
    assert both["check"]["device-vs-farm"]["complete"], both["check"]
    assert both["check"]["farm-instances"] == opts["record_instances"]
    flagged = set(dev["check"]["flagged-instance-ids"])
    assert dev["valid?"] == both["valid?"]
    for bv, dv in zip(both["instances"], dev["instances"]):
        i = bv["instance"]
        assert dv["instance"] == i and dv.get("valid?") == bv.get("valid?")
        if i in flagged:
            assert dv == bv, (workload, i)
        else:
            assert dv.get("checked-by") == "device-summary", (workload, i)
    rec = dev["perf"]["phases"]["check"]
    assert rec["check-mode"] == "device" and rec["mode"] == "serial"
    assert rec["farm-load-fraction"] == dev["check"]["farm-load-fraction"]
