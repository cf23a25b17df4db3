"""The port's bench lines against the live JAX bench child, on the CPU.

One module fixture runs ``bench.py --child`` (``JAX_PLATFORMS=cpu``) and
``python -m maelstrom_tpu_torch.bench --device cpu`` side by side with
the same environment (the port's store off by its flag, as the JAX
child's by ``BENCH_AOT=0``). On the CPU both run the native C++ engine
first (``BENCH_NATIVE_INSTANCES`` 256 for 0.5 simulated seconds: its
four checked family runs, its ``k1`` and ``k3`` lines), then their own
device engine's ``k1`` as ``jax-k1`` / ``torch-k1``
(``BENCH_JAX_INSTANCES`` 256 for 0.4 simulated seconds, so the chunk
plan, two 32-tick warm-up chunks, a provisional 256-tick chunk and two
timed 32-tick chunks, 384 ticks, leaves a timed window, and the funnel
runs). The static passes that have tests of their own are off (the JAX
shard and ranges passes and its warm AOT path fail on jax 0.9).

- The device engine: one line per stage; the last one of each must
  agree on every count, the event stream, the verdict stage and the
  funnel, and carry the same keys but those without a counterpart in
  the port (``torch-k1`` read as ``jax-k1``).
- The native engine: the ``k1`` and ``k3`` lines and the families block
  agree on every count (the times and the host-speed spin aside).
- The merged line: the port's equals the one the JAX parent
  (``parent_main``) builds from the JAX child's lines, on every count,
  with ``torch_engine`` read as ``jax_engine``.
"""

import json
import os
import subprocess
import sys

import pytest

from torch_tutorial_cases import one_thread_env, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = dict(BENCH_NATIVE_INSTANCES="256", BENCH_NATIVE_SIM_SECONDS="0.5",
           BENCH_JAX_INSTANCES="256", BENCH_JAX_SIM_SECONDS="0.4",
           BENCH_DISPATCH_S="1000",
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
# the device engine's config beside the native lines, in each package
ENGINES = {"jax-k1", "torch-k1"}
# the native lines' fields that time the run or the host
NATIVE_TIMES = {"value", "vs_baseline", "wall_s", "host_spin_s",
                "families"}


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


def _engine(lines):
    """The device engine's lines, ``torch-k1`` read as ``jax-k1``."""
    return [dict(r, config="jax-k1") for r in lines
            if r["config"] in ENGINES]


def _last_k1(lines):
    return _engine(lines)[-1]


def _native(lines, config):
    """The native engine's lines of ``config`` (the merged line, which
    carries ``secondary``, left out)."""
    return [r for r in lines if r.get("engine") == "native-cpp"
            and r["config"] == config and "secondary" not in r]


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
    assert {r["config"] for r in runs[1] if r["engine"] == "torch"} == \
        {"torch-k1"}
    assert {r["config"] for r in runs[0] if r["engine"] == "jax"} == \
        {"jax-k1"}


@pytest.mark.parametrize("field", TIMINGS)
def test_timings_present_and_positive(runs, field):
    for lines in runs:
        assert _last_k1(lines)[field] > 0, field


def test_each_stage_prints_jax_s_line(runs):
    """A line per stage, as the JAX child prints them: the warm-up and
    provisional chunks, each timed chunk, the verdict stage, the funnel
    (the port's last line is the merged one, here the same as k1's)."""
    jax_lines, port_lines = (_engine(lines) for lines in runs)
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


@pytest.mark.parametrize("config", ["k1", "k3"])
def test_native_line_equals_jax(runs, config):
    """The native engine's line: printed once, before the device engine's
    lines, with JAX's keys and every count equal."""
    (jl,), (pl,) = (_native(lines, config) for lines in runs)
    for lines in runs:
        assert lines.index(_native(lines, config)[0]) < 2
    assert set(pl) == set(jl)
    assert {k: v for k, v in pl.items() if k not in NATIVE_TIMES} == \
        {k: v for k, v in jl.items() if k not in NATIVE_TIMES}
    assert pl["complete"] is True and pl["events_truncated"] is False
    assert pl["funnel"]["replayed"] == 4
    assert pl["value"] > 0 and pl["wall_s"] > 0
    assert ("host_spin_s" in pl) == ("families" in pl) == (config == "k1")


def test_native_families_equal_jax(runs):
    """The four checked family runs: every count and verdict equal."""
    (jl,), (pl,) = (_native(lines, "k1") for lines in runs)
    fam, jfam = pl["families"], jl["families"]
    assert sorted(fam) == sorted(jfam) == ["g-set", "kafka", "pn-counter",
                                           "txn-list-append"]
    for name in fam:
        assert fam[name]["msgs_per_sec"] > 0
        assert {k: v for k, v in fam[name].items() if k != "msgs_per_sec"} \
            == {k: v for k, v in jfam[name].items() if k != "msgs_per_sec"}
        assert fam[name]["recorded_checker_verdicts"] == [True, True]
    assert set(pl["host_spin_s"]) == {"before", "after"}


def _counts(rec):
    """A merged line without its times: the native headline's, its
    families' rates and the device engine's block."""
    out = {k: v for k, v in rec.items() if k not in NATIVE_TIMES}
    out["families"] = {name: {k: v for k, v in f.items()
                              if k != "msgs_per_sec"}
                       for name, f in rec["families"].items()}
    out["engine_block"] = {k: v for k, v in out.pop(
        "torch_engine" if "torch_engine" in rec else "jax_engine").items()
        if k not in ("value", "vs_baseline", "wall_s")}
    out["engine_block"]["config"] = "jax-k1"
    out["secondary"] = {k: v for k, v in rec["secondary"].items()
                        if k not in ("value", "vs_baseline", "wall_s")}
    return out


def test_merged_line_equals_jax_parent_s(runs, monkeypatch, capsys):
    """The JAX parent (``parent_main``, its children stubbed: a canary
    that finds no accelerator, then a CPU child that prints the live JAX
    child's lines) merges the native ``k1`` headline, ``k3`` as
    ``secondary`` and ``jax-k1`` as ``jax_engine``: the port's last line
    is that line, ``torch_engine`` for ``jax_engine``."""
    import importlib.util
    from maelstrom_tpu.utils import driver_guard
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    jax_lines, port_lines = runs

    def run_child(cmd, env, deadline, tag):
        if "--canary" in cmd:
            return 0, json.dumps({"canary": True, "platform": "cpu"}), []
        return 0, "\n".join(json.dumps(r) for r in jax_lines), []

    monkeypatch.setattr(driver_guard, "run_child", run_child)
    monkeypatch.setattr(driver_guard, "cpu_child_env", lambda n: {})
    assert root_bench.parent_main() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for rec in (want, *want.values()):
        if isinstance(rec, dict):
            rec.pop("attempt", None)
    got = port_lines[-1]
    assert got["engine"] == "native-cpp" and got["config"] == "k1"
    assert got["torch_engine"]["config"] == "torch-k1"
    assert "alt_scale" not in got
    assert set(got) - {"torch_engine"} == set(want) - {"jax_engine"}
    assert set(got["torch_engine"]) == set(want["jax_engine"])
    assert _counts(got) == _counts(want)
