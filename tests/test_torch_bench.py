"""The port's bench line against the live JAX bench child, on the CPU.

One module fixture runs ``bench.py --child`` (``JAX_PLATFORMS=cpu``) and
``python -m maelstrom_tpu_torch.bench --device cpu`` side by side with
the same environment (the port's store off by its flag, as the JAX
child's by ``BENCH_AOT=0``): 256 instances for 0.4 simulated seconds, so the
chunk plan (two 32-tick warm-up chunks, a provisional 256-tick chunk,
two timed 32-tick chunks; 384 ticks) leaves a timed window, and the
funnel runs. The static passes that have tests of their own are off
(the JAX shard and ranges passes and its warm AOT path fail on jax 0.9).
Both print one line per stage; the last ``k1`` line of each must agree
on every count, the event stream, the verdict stage and the funnel, and
carry the same keys but those without a counterpart in the port.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_tutorial_cases import one_thread_env, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = dict(BENCH_NO_NATIVE="1", BENCH_INSTANCES="256",
           BENCH_SIM_SECONDS="0.4", BENCH_DISPATCH_S="1000",
           BENCH_IR_THUNKS="0", BENCH_LANES="0", BENCH_RANGES="0",
           BENCH_SHARD="0", BENCH_AOT="0", MAELSTROM_COMPILE_CACHE="0")

# the JAX line's fields that count a compiled XLA executable, which the
# port has none of (maelstrom_tpu_torch/bench.py's docstring)
NO_COUNTERPART = {"ir_thunks", "ir_while_loops"}

EQUAL = ("config", "instances", "inbox_k", "pool_slots", "sim_ticks",
         "sent", "delivered", "delivered_timed", "dropped_overflow",
         "latency_ticks", "msg_lanes", "bytes_per_msg_row", "wide",
         "fault_fuzz", "fuzz_phases", "pipeline", "heartbeat",
         "heartbeat_records", "event_capacity", "event_bytes_fetched",
         "event_bytes_dense", "fetch_reduction_x", "overflowed_chunks",
         "check_mode", "check_workers", "check_pool", "farm_load_fraction",
         "check_valid", "complete", "funnel", "bytes_per_instance")
TIMINGS = ("value", "wall_s", "decode_s", "check_s", "verdicts_per_s")


def _lines(out: str):
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def start_benches(env_extra, tmp_path_factory):
    """Start the JAX bench child and the port's bench on the CPU with
    the same ``BENCH_*`` environment, each in a temporary working
    directory of its own (the JAX child writes its compile cache beside
    its working directory); :func:`finish_benches` collects them."""
    path = os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                           if p)
    jax_env = dict(os.environ, **env_extra, PYTHONPATH=path,
                   JAX_PLATFORMS="cpu")
    port_env = dict(one_thread_env(), **env_extra, PYTHONPATH=path)
    pipe = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return [
        subprocess.Popen([sys.executable, os.path.join(REPO, "bench.py"),
                          "--child"], cwd=tmp_path_factory.mktemp("jax"),
                         env=jax_env, **pipe),
        subprocess.Popen([sys.executable, "-m", "maelstrom_tpu_torch.bench",
                          "--device", "cpu", "--aot-store", "off"],
                         cwd=tmp_path_factory.mktemp("port"), env=port_env,
                         **pipe)]


def finish_benches(procs):
    """``(jax lines, port lines)`` of :func:`start_benches`' runs."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            outs.append(_lines(out))
    finally:
        for p in procs:
            p.kill()
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax lines, port lines)``: both benches run at once."""
    return finish_benches(start_benches(ENV, tmp_path_factory))


def _last_k1(lines):
    return [r for r in lines if r["config"] == "k1"][-1]


@pytest.mark.parametrize("field", EQUAL)
def test_last_k1_line_field_equals_jax(runs, field):
    """Counters, latency, the event stream, the verdict stage and the
    funnel block: equal to the JAX child's. ``bytes_per_instance`` is
    equal too: the port counts its int64 master key as the JAX carry's
    ``[2]`` uint32, and every other leaf has JAX's dtype and shape."""
    jl, pl = (_last_k1(lines) for lines in runs)
    assert field in jl, field
    assert pl.get(field) == jl[field], field


def test_last_k1_line_key_set_is_jax_s(runs):
    jl, pl = (_last_k1(lines) for lines in runs)
    assert set(pl) == set(jl) - NO_COUNTERPART
    assert pl["engine"] == "torch" and pl["platform"] == "cpu"


@pytest.mark.parametrize("field", TIMINGS)
def test_timings_present_and_positive(runs, field):
    for lines in runs:
        assert _last_k1(lines)[field] > 0, field


def test_each_stage_prints_jax_s_line(runs):
    """A line per stage, as the JAX child prints them: the warm-up and
    provisional chunks, each timed chunk, the verdict stage, the funnel
    (the port's last line is the merged one, here the same as k1's)."""
    jax_lines, port_lines = runs
    assert port_lines[-1] == port_lines[-2]
    port_lines = port_lines[:-1]
    assert len(port_lines) == len(jax_lines) == 6

    def shape(r):
        return (r["sim_ticks"], r.get("provisional"), r.get("complete"),
                "latency_ticks" in r, "check_valid" in r, "funnel" in r,
                sorted(set(r) - NO_COUNTERPART))
    assert [shape(r) for r in port_lines] == [shape(r) for r in jax_lines]
    assert [r["sim_ticks"] for r in port_lines] == [32, 320, 352, 384, 384,
                                                     384]
    assert [r["funnel"]["verdicts"] for r in port_lines if "funnel" in r] \
        == [{"36": True, "85": True, "129": True, "254": True}]
