"""The port's ``device`` and ``both`` modes against the JAX harness, live,
on the registered workload families that ``test_torch_device_check.py``
leaves to the lanes' unit tests: the txn models and a dirty-apply mutant
(the Raft lane they inherit, whose applied-truncation witness flags the
dirty apply), broadcast (the g-set lane), g-counter (the counter lane)
and a kafka mutant — at the JAX lane tests' ``BASE_OPTS`` cut to 200
ticks, kafka at its one-node shape. The results blocks (``check``
included) equal JAX's in both modes, ``both``'s audit is complete, and
device mode's per-instance ``valid?`` equals ``both`` mode's.

Tolerance: exact."""

import pytest

from test_torch_device_check import assert_same, run_pair, workload_opts
from torch_tutorial_cases import one_torch_thread  # noqa: F401 (autouse)

FAMILIES = ["txn-list-append", "txn-rw-register-bug-dirty-apply",
            "broadcast", "g-counter", "kafka-bug-commit-regression"]


@pytest.mark.parametrize("workload", FAMILIES)
def test_family_device_and_both_match_jax(workload):
    opts = workload_opts("kafka" if workload.startswith("kafka")
                         else workload)
    dev_j, dev = run_pair(workload, dict(opts, check_mode="device"))
    both_j, both = run_pair(workload, dict(opts, check_mode="both"))
    assert_same(dev_j, dev, f"{workload} device")
    assert_same(both_j, both, f"{workload} both")
    assert both["check"]["device-vs-farm"]["complete"], both["check"]
    assert [v.get("valid?") for v in dev["instances"]] == \
        [v.get("valid?") for v in both["instances"]]
