"""The port's bench lines against the live JAX bench child under the
bench's other switches, on the CPU.

Three pairs run at once, 64 instances for 0.15 simulated seconds with
a dispatch budget that keeps every chunk at 32 ticks (two warm-up
chunks, a timed window of two): the monolithic path
(``BENCH_PIPELINE=0``: no event stream, a sync on the carry per chunk);
the device verdict lanes routing the farm (``BENCH_CHECK_MODE=device``)
on the wide rows (``BENCH_WIDE=1``) without the heartbeat, the fault
distribution or the profiler; and neither the verdict stage, the funnel
nor telemetry. Every line of each run must equal the JAX child's line
for line: the same keys, the same values but the timings.
"""

import pytest

from test_torch_bench import ENV, finish_benches, start_benches
from torch_tutorial_cases import one_torch_thread  # noqa: F401

# the device engine alone: the native engine's lines are held to JAX's
# in tests/test_torch_bench.py
SMALL = dict(ENV, BENCH_NO_NATIVE="1", BENCH_INSTANCES="64",
             BENCH_SIM_SECONDS="0.15", BENCH_DISPATCH_S="0.0001")
VARIANTS = {
    "monolithic": dict(BENCH_PIPELINE="0"),
    "device-lanes-wide": dict(BENCH_CHECK_MODE="device", BENCH_WIDE="1",
                              BENCH_HEARTBEAT="0", BENCH_FUZZ="0",
                              BENCH_DEVICE_PROFILE="0"),
    "no-check-funnel-telemetry": dict(BENCH_CHECK="0", BENCH_FUNNEL="0",
                                      BENCH_TELEMETRY="0"),
}
# measured, or the static trace's (the port's tick is another graph)
UNEQUAL = {"value", "vs_baseline", "wall_s", "decode_s", "check_s",
           "verdicts_per_s", "first_dispatch_s", "device_ms_per_tick",
           "device_phase_ms_per_tick", "ir_eqns", "ir_bytes_est", "engine"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    started = {name: start_benches(dict(SMALL, **env), tmp_path_factory)
               for name, env in VARIANTS.items()}
    return {name: finish_benches(procs) for name, procs in started.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lines_equal_jax_s(runs, variant):
    jax_lines, port_lines = runs[variant]
    assert port_lines[-1] == port_lines[-2]    # the merged line: k1's
    port_lines = port_lines[:-1]
    assert [r["sim_ticks"] for r in port_lines] == \
        [r["sim_ticks"] for r in jax_lines]
    for want, got in zip(jax_lines, port_lines):
        assert set(got) == set(want)
        assert {k: v for k, v in got.items() if k not in UNEQUAL} == \
            {k: v for k, v in want.items() if k not in UNEQUAL}
    assert jax_lines[-1]["sim_ticks"] == 128
    assert port_lines[-1]["value"] > 0
