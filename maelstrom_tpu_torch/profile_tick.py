"""Where a tick's time goes on the card: a fleet under ``torch.profiler``.

    python -m maelstrom_tpu_torch.profile_tick [--workload lin-kv]
        [--node-count N] [--topology T] [--pool-slots S]
        [--instances 4096] [--ticks 20] [--fuzz] [--lanes]
        [--out chiprun_out/tick_profile.json]

Runs a fleet of ``fleets.py`` on ``cuda``: for lin-kv (the default) the
flagship (3 nodes, 6 clients, inbox_k=1, 16 pool slots, exponential
latency, 5% loss, the partition nemesis, telemetry on); for broadcast
the guide's 25-node tree4 fleet (25 clients, S=256, K=8); for
txn-list-append and txn-rw-register ``fleets.TXN``; for kafka
``fleets.KAFKA`` (1 node, no nemesis); for a lin-kv mutant the bug hunt
``fleets.BUG_HUNT`` (3 nodes, 3 clients, S=128, K=8); for the other
tutorial workloads their family run. ``--node-count`` (clients follow
at one per node for broadcast), ``--topology`` and ``--pool-slots``
change it. ``--fuzz`` adds the benchmark's all-healthy fault
distribution (``faults.fuzz.BENCH_FUZZ_DIST``) as a second
configuration in the same process, and ``--lanes`` the device verdict
lanes (``check_mode="device"``). Each configuration warms up past the
first partition phase (t >= 400); then ``--ticks`` ticks are timed on
the host clock around a synchronize (wall ms/tick), in turns in the
order given and back (bare, fuzz, lanes, lanes, fuzz, bare), and each
configuration profiles the same number of ticks. Per configuration and per tick it reports the kernels launched,
the device-busy time (sum of kernel durations) and so the idle share,
the delivery kernel's device time, and per phase (the runtime's
``record_function`` ranges) the host time and the busy device time of
its kernels, and beside them the static operators per tick of the same
tick variant (``analysis/cost_model.py``, a trace on ``meta`` tensors:
``static_ops_per_tick``, per phase and in all; the prediction of the
kernels launched, as ``tools/tick_profile.py`` prints the JAX cost
model's equations next to its measured phases). Prints one JSON object
and writes it to ``--out``. Needs a CUDA card; refuses to run without
one.

``--count-ops`` needs no card: it steps the same fleet at 8 instances
on the CPU and prints the operators dispatched per tick, views left
out — on the card nearly each is one kernel launch (4,136 for the
flagship against the 4,134 kernels its card profile shows), so it
predicts a tick's launches before a chip run; with ``--lanes`` also
with the lanes on. It prints the static count of the same tick beside
them.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time

import torch

PHASES = ("nemesis", "faults", "deliver", "node_phase", "client_step",
          "enqueue", "check_summary", "telemetry")


class _Fleet:
    """One configuration's carry and tick, stepped from tick 0."""

    def __init__(self, model, opts, dev):
        from . import harness, runtime
        sim = harness.make_sim_config(model, opts)
        self.model, self.sim = model, sim
        self.carry = runtime.init_carry(model, sim, opts["seed"], dev)
        self.tick = runtime.make_tick_fn(model, sim, device=dev)
        self.t = 0

    def run(self, n: int) -> None:
        for _ in range(n):
            self.carry, _ = self.tick(self.carry, self.t)
            self.t += 1

    def wall_ms(self, n: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n


def _breakdown(fleet: _Fleet, n: int, wall_ms: float, kernel_name: str):
    """Profile ``n`` ticks: kernels, busy and idle share, per phase."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fleet.run(n)
        torch.cuda.synchronize()
    # host side: each phase's record_function range on the CPU; device
    # side: the kernels (and copies) on the card, each charged to the
    # phase whose device-timeline annotation range holds its start
    on_card = lambda e: str(e.device_type).endswith("CUDA")
    host_us = {ph: 0.0 for ph in PHASES}
    spans = []
    kernels = []
    for e in prof.events():
        if e.name in PHASES:
            if on_card(e):
                spans.append((e.time_range.start, e.time_range.end, e.name))
            else:
                host_us[e.name] += e.time_range.elapsed_us()
        elif on_card(e):
            kernels.append(e)
    spans.sort()
    starts = [lo for lo, _, _ in spans]
    dev_us = {ph: 0.0 for ph in PHASES}
    kernels_in = {ph: 0 for ph in PHASES}
    by_name = {}
    for k in kernels:
        d = k.time_range.elapsed_us()
        i = bisect.bisect_right(starts, k.time_range.start) - 1
        if i >= 0 and k.time_range.start <= spans[i][1]:
            dev_us[spans[i][2]] += d
            kernels_in[spans[i][2]] += 1
        c, tot = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (c + 1, tot + d)
    busy_us = sum(k.time_range.elapsed_us() for k in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    deliver = [v for name, v in by_name.items() if kernel_name in name]
    return {
        "ticks_profiled": n,
        "from_tick": fleet.t - n,
        "wall_ms_per_tick": wall_ms,
        "device_kernels_per_tick": len(kernels) / n,
        "device_busy_ms_per_tick": busy_us / 1e3 / n,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / n / wall_ms),
        "deliver_kernel_device_ms": (deliver[0][1] / deliver[0][0] / 1e3
                                     if deliver else None),
        "phases": {ph: {"host_ms_per_tick": host_us[ph] / 1e3 / n,
                        "device_busy_ms_per_tick": dev_us[ph] / 1e3 / n,
                        "device_kernels_per_tick": kernels_in[ph] / n}
                   for ph in PHASES},
        "top_kernels": [{"kernel": name[:120], "per_tick": c / n,
                         "device_ms_per_tick": tot / 1e3 / n}
                        for name, (c, tot) in top],
    }


def static_ops(model, sim, t: int) -> dict:
    """The static operators per tick of ``sim``'s tick at the variant of
    tick ``t`` (``analysis/cost_model.py``): ``{"variant", "ops_per_tick",
    "phases": {phase: ops}}`` over :data:`PHASES` and ``other``."""
    from .analysis import cost_model
    rep = cost_model.cost_of_graph(cost_model.trace_tick(model, sim, t))
    phases = {ph: 0 for ph in PHASES + ("other",)}
    for raw, n in rep.scopes.items():
        phases[raw if raw in phases else "other"] += n
    return {"variant": cost_model.variant_tick(sim, t),
            "ops_per_tick": rep.eqns, "phases": phases}


# operators that only make views: they launch no kernel
_VIEW_OPS = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "select",
    "slice", "as_strided", "unsqueeze", "squeeze", "t", "permute",
    "transpose", "detach", "alias", "unbind", "split", "split_with_sizes",
    "chunk", "narrow", "view_as", "lift_fresh"))


def dispatched_ops_per_tick(model, opts, from_tick: int, ticks: int
                            ) -> float:
    """Non-view operators dispatched per tick over ``[from_tick,
    from_tick + ticks)`` of a CPU run of the fleet."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from . import harness, runtime

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ not in _VIEW_OPS:
                self.n += 1
            return func(*args, **(kwargs or {}))

    sim = harness.make_sim_config(model, opts)
    carry = runtime.init_carry(model, sim, opts["seed"], "cpu")
    tick = runtime.make_tick_fn(model, sim, device="cpu")
    counter = _Count()
    with torch.no_grad():
        for t in range(from_tick + ticks):
            if t == from_tick:
                counter.__enter__()
            carry, _ = tick(carry, t)
        counter.__exit__(None, None, None)
    return counter.n / ticks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m maelstrom_tpu_torch."
                                      "profile_tick")
    ap.add_argument("--workload", default="lin-kv",
                    help="a ported workload or mutant (models.WORKLOADS, "
                         "models.MUTANTS)")
    ap.add_argument("--node-count", type=int)
    ap.add_argument("--topology",
                    help="gossip topology (broadcast, g-set)")
    ap.add_argument("--pool-slots", type=int)
    ap.add_argument("--instances", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--warmup-to", type=int, default=420)
    ap.add_argument("--fuzz", action="store_true",
                    help="also profile under the benchmark's all-healthy "
                         "fault distribution, in the same process")
    ap.add_argument("--lanes", action="store_true",
                    help="also profile with the device verdict lanes on "
                         "(check_mode device), in the same process")
    ap.add_argument("--count-ops", action="store_true",
                    help="count the operators a tick dispatches, on the "
                         "CPU at 8 instances (no card needed)")
    ap.add_argument("--out", default="chiprun_out/tick_profile.json")
    args = ap.parse_args(argv)
    if not args.count_ops and not torch.cuda.is_available():
        raise SystemExit("profile_tick needs a CUDA card")

    from . import fleets
    from .faults.fuzz import BENCH_FUZZ_DIST
    from .kernels import build, delivery, devtime
    from .models import get_model

    model, opts = fleets.fleet(args.workload)
    opts["n_instances"] = args.instances
    if args.pool_slots is not None:
        opts["pool_slots"] = args.pool_slots
    if args.node_count is not None or args.topology is not None:
        n = args.node_count or opts["node_count"]
        if args.workload == "broadcast":
            opts["concurrency"] = n
        opts["node_count"] = n
        model = get_model(args.workload, n, args.topology
                          or getattr(model, "topology", "grid"),
                          fleets.FLAGSHIP_MODEL_KW
                          if args.workload == "lin-kv" else None)
    if args.count_ops:
        from . import harness
        rec = {"workload": args.workload,
               "dispatched_ops_per_tick": dispatched_ops_per_tick(
                   model, dict(opts, n_instances=8), args.warmup_to,
                   args.ticks),
               "static": static_ops(model, harness.make_sim_config(
                   model, opts), args.warmup_to)}
        if args.lanes:
            rec["dispatched_ops_per_tick_lanes"] = dispatched_ops_per_tick(
                model, dict(opts, n_instances=8, check_mode="device"),
                args.warmup_to, args.ticks)
        print(json.dumps(rec))
        return 0
    build.build_all([delivery.SOURCE])
    dev = torch.device("cuda")
    configs = {"bare": opts}
    if args.fuzz:
        configs["fuzz"] = dict(opts, fault_fuzz=BENCH_FUZZ_DIST)
    if args.lanes:
        configs["lanes"] = dict(opts, check_mode="device")
    runs = {}
    with torch.no_grad():
        for name, o in configs.items():
            runs[name] = _Fleet(model, o, dev)
            runs[name].run(args.warmup_to)
        order = list(configs) + list(configs)[::-1]   # bare, ..., bare
        walls = {name: [] for name in configs}
        for name in order:
            walls[name].append(runs[name].wall_ms(args.ticks))
        rec = {"card": devtime.card_line(), "workload": args.workload,
               "node_count": opts["node_count"],
               "topology": getattr(model, "topology", None),
               "pool_slots": opts["pool_slots"],
               "inbox_k": opts["inbox_k"], "instances": args.instances,
               "wall_order": order, "configs": {}}
        for name, fleet in runs.items():
            wall = sum(walls[name]) / len(walls[name])
            b = _breakdown(fleet, args.ticks, wall, delivery.KERNEL_NAME)
            st = static_ops(fleet.model, fleet.sim, b["from_tick"])
            for ph, d in b["phases"].items():
                d["static_ops_per_tick"] = st["phases"][ph]
            rec["configs"][name] = dict(
                b, wall_ms_runs=walls[name], static_variant=st["variant"],
                static_ops_per_tick=st["ops_per_tick"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
