"""Randomized per-instance fault schedules, drawn on the device.

Counterpart of ``maelstrom_tpu/faults/fuzz.py``. A fault distribution
(CLI ``--fault-fuzz file.json``) compiles to a static
:class:`FuzzConfig`; at ``init_carry`` every instance draws its OWN
:class:`FaultSchedule` from the schedule-RNG purpose (``RNG_PURPOSE``),
bit-identical to the JAX draw, and the schedule rides the carry
(``Carry.fault_sched``). Each tick, :func:`schedule_planes` selects
every instance's planes with one batched ``searchsorted``.

Distribution format (ranges are inclusive ``[lo, hi]``; scalars read as
``lo == hi``):

.. code-block:: json

    {"windows": [1, 3],
     "gap": [50, 200],
     "duration": [30, 120],
     "crash": {"rate": 0.8, "victims": [1, 2]},
     "links": {"rate": 0.5, "edges": [1, 4], "block": 0.3,
               "delay": [0, 40], "loss": [0.0, 0.4]},
     "skew":  {"rate": 0.3, "victims": [1, 2], "range": [0.5, 2.0]},
     "membership": {"rate": 0.4, "victims": [1, 2]},
     "snapshot_every": 1}

Each window is a healthy ``gap`` followed by a ``duration``-tick fault
phase; ``rate`` is a lane's per-window activation probability. A lane
configured at rate 0 stays in the tick with neutral planes (zero
delay and loss, rate-64 clocks, no crashes), which leaves the
trajectory exactly that of the fault-free run: ``bench.py``'s flagship
runs :data:`BENCH_FUZZ_DIST` so, and its ``BENCH_FUZZ=0`` A/B prices
the schedule machinery.

Every draw is integer-only (``randint``, ``permutation``), so a
schedule is a pure function of ``(seed, instance id)``:
:func:`reconstruct_schedule` re-draws one, :func:`schedule_to_plan`
lowers it to a deterministic ``--fault-plan`` dict whose planes are
value-identical at every tick (:func:`reconstruct_plan` does both, for
triage and the shrinker), and :func:`span_counters` counts the fleet's
windows over a chunk for the heartbeat.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import rng
from .engine import NEUTRAL_RATE, FaultConfig, FaultPlanes
from .spec import (MAX_DELAY_TICKS, MAX_MEMBER_NODES, MAX_RATE, MIN_RATE,
                   SpecError, _get, membership_heal_phases)

# the schedule-RNG purpose tag (runtime._RNG_FAULTS): keys fold (master,
# RNG_PURPOSE, instance id), tick-independent
RNG_PURPOSE = 6

MAX_WINDOWS = 16          # 2*W untils stay far inside int32 ticks

# bench.py's flagship distribution: the links and skew lanes configured
# at rate 0, so the schedule draw and the per-tick plane selection run
# while the trajectory stays the bare run's
BENCH_FUZZ_DIST = {
    "windows": [2, 4], "gap": [40, 200], "duration": [20, 100],
    "links": {"rate": 0.0, "edges": [1, 2]},
    "skew": {"rate": 0.0, "victims": [1, 1]},
}


class LaneFuzz(NamedTuple):
    """One lane's slice of the distribution (all-int, hashable).
    ``victims_max == 0``: the lane is not configured."""
    rate_pm: int = 0          # per-window activation probability (per-mille)
    victims_min: int = 0      # victim count range (nodes, or directed
    victims_max: int = 0      # edges for the links lane)
    block_pm: int = 0         # links: P(edge blocked), per-mille
    delay_min: int = 0        # links: extra latency ticks
    delay_max: int = 0
    loss_pm_min: int = 0      # links: per-mille loss
    loss_pm_max: int = 0
    rate64_min: int = NEUTRAL_RATE   # skew: clock rate in 64ths
    rate64_max: int = NEUTRAL_RATE


class FuzzConfig(NamedTuple):
    """Compiled fault distribution (rides ``FaultConfig.fuzz``)."""
    enabled: bool = False
    windows_min: int = 0
    windows_max: int = 0
    gap_min: int = 0
    gap_max: int = 0
    dur_min: int = 0
    dur_max: int = 0
    crash: LaneFuzz = LaneFuzz()
    links: LaneFuzz = LaneFuzz()
    skew: LaneFuzz = LaneFuzz()
    membership: LaneFuzz = LaneFuzz()

    @property
    def has_crash(self) -> bool:
        return self.enabled and self.crash.victims_max > 0

    @property
    def has_links(self) -> bool:
        return self.enabled and self.links.victims_max > 0

    @property
    def has_skew(self) -> bool:
        return self.enabled and self.skew.victims_max > 0

    @property
    def has_membership(self) -> bool:
        return self.enabled and self.membership.victims_max > 0


class FaultSchedule(NamedTuple):
    """The drawn schedules, every leaf ``[I, ...]``. ``untils`` is the
    interleaved heal/fault timeline: phase ``2w`` is window ``w``'s
    healthy gap, phase ``2w + 1`` the window itself."""
    untils: torch.Tensor        # [I, 2W] int32 cumulative boundaries
    crash: torch.Tensor         # [I, W, N] bool
    edge_dst: torch.Tensor      # [I, W, E] int32
    edge_src: torch.Tensor      # [I, W, E] int32
    edge_block: torch.Tensor    # [I, W, E] int32 0/1
    edge_delay: torch.Tensor    # [I, W, E] int32 extra ticks
    edge_loss_pm: torch.Tensor  # [I, W, E] int32 per-mille
    skew: torch.Tensor          # [I, W, N] int32 rate64
    mem_out: torch.Tensor       # [I, W, N] bool, removed during window w


def _err(msg: str) -> SpecError:
    return SpecError(f"fault fuzz: {msg}")


def _range(v, what: str, lo_bound, hi_bound, cast=int) -> Tuple:
    """Parse an inclusive ``[lo, hi]`` range (scalar = degenerate)."""
    if isinstance(v, (list, tuple)):
        if len(v) != 2:
            raise _err(f"{what} range must be [lo, hi], got {v!r}")
        lo, hi = cast(v[0]), cast(v[1])
    else:
        try:
            lo = hi = cast(v)
        except (TypeError, ValueError):
            raise _err(f"{what} {v!r} is not a number or [lo, hi]")
    if lo > hi:
        raise _err(f"{what} range [{lo}, {hi}] has lo > hi")
    if lo < lo_bound or hi > hi_bound:
        raise _err(f"{what} range [{lo}, {hi}] out of "
                   f"[{lo_bound}, {hi_bound}]")
    return lo, hi


def _rate_pm(v, what: str) -> int:
    p = float(v or 0.0)
    if not 0.0 <= p <= 1.0:
        raise _err(f"{what} rate {p} out of [0, 1]")
    return int(round(p * 1000))


def validate_fault_fuzz(dist: Dict[str, Any], n_nodes: int) -> None:
    """Raise :class:`SpecError` on a malformed distribution."""
    if not isinstance(dist, dict):
        raise _err(f"top level must be a dict, got "
                   f"{type(dist).__name__}")
    _range(_get(dist, "windows", 1), "windows", 1, MAX_WINDOWS)
    _range(_get(dist, "gap", [0, 0]), "gap", 0, MAX_DELAY_TICKS)
    _range(_get(dist, "duration", [1, 1]), "duration", 1,
           MAX_DELAY_TICKS)
    every = _get(dist, "snapshot_every", 1)
    if every is not None and int(every) < 1:
        raise _err(f"snapshot_every must be >= 1, got {every}")
    lanes = 0
    crash = _get(dist, "crash")
    if crash is not None:
        _rate_pm(_get(crash, "rate", 0.0), "crash")
        _range(_get(crash, "victims", 1), "crash victims", 1, n_nodes)
        lanes += 1
    links = _get(dist, "links")
    if links is not None:
        if n_nodes < 2:
            raise _err("links lane needs >= 2 server nodes")
        _rate_pm(_get(links, "rate", 0.0), "links")
        _range(_get(links, "edges", 1), "links edges", 1,
               n_nodes * (n_nodes - 1))
        _rate_pm(_get(links, "block", 0.0), "links block")
        _range(_get(links, "delay", [0, 0]), "links delay", 0,
               MAX_DELAY_TICKS)
        _range(_get(links, "loss", [0.0, 0.0]), "links loss", 0.0, 1.0,
               cast=float)
        lanes += 1
    skew = _get(dist, "skew")
    if skew is not None:
        _rate_pm(_get(skew, "rate", 0.0), "skew")
        _range(_get(skew, "victims", 1), "skew victims", 1, n_nodes)
        _range(_get(skew, "range", [1.0, 1.0]), "skew range", MIN_RATE,
               MAX_RATE, cast=float)
        lanes += 1
    mem = _get(dist, "membership")
    if mem is not None:
        if n_nodes < 2:
            raise _err("membership lane needs >= 2 server nodes "
                       "(removing the only node would empty the "
                       "cluster)")
        if n_nodes > MAX_MEMBER_NODES:
            raise _err(f"membership lane supports at most "
                       f"{MAX_MEMBER_NODES} server nodes (int32 "
                       f"member bitmask), got n_nodes={n_nodes}")
        _rate_pm(_get(mem, "rate", 0.0), "membership")
        # victims cap n_nodes - 1: no draw may ever empty the cluster
        _range(_get(mem, "victims", 1), "membership victims", 1,
               n_nodes - 1)
        lanes += 1
    if lanes == 0:
        raise _err("needs at least one lane block "
                   "(crash / links / skew / membership)")


def compile_fault_fuzz(dist: Optional[Dict[str, Any]], n_nodes: int,
                       stop_tick: int,
                       snapshot_every: Optional[int] = None
                       ) -> FaultConfig:
    """Lower a distribution dict to the static :class:`FaultConfig`
    carrying a :class:`FuzzConfig` (``dist=None``: the disabled config)."""
    if not dist:
        return FaultConfig()
    validate_fault_fuzz(dist, n_nodes)
    w_lo, w_hi = _range(_get(dist, "windows", 1), "windows", 1,
                        MAX_WINDOWS)
    g_lo, g_hi = _range(_get(dist, "gap", [0, 0]), "gap", 0,
                        MAX_DELAY_TICKS)
    d_lo, d_hi = _range(_get(dist, "duration", [1, 1]), "duration", 1,
                        MAX_DELAY_TICKS)
    crash = links = skew = membership = LaneFuzz()
    c = _get(dist, "crash")
    if c is not None:
        v_lo, v_hi = _range(_get(c, "victims", 1), "crash victims", 1,
                            n_nodes)
        crash = LaneFuzz(rate_pm=_rate_pm(_get(c, "rate", 0.0), "crash"),
                         victims_min=v_lo, victims_max=v_hi)
    e = _get(dist, "links")
    if e is not None:
        e_lo, e_hi = _range(_get(e, "edges", 1), "links edges", 1,
                            n_nodes * (n_nodes - 1))
        dl_lo, dl_hi = _range(_get(e, "delay", [0, 0]), "links delay",
                              0, MAX_DELAY_TICKS)
        lp_lo, lp_hi = _range(_get(e, "loss", [0.0, 0.0]), "links loss",
                              0.0, 1.0, cast=float)
        links = LaneFuzz(
            rate_pm=_rate_pm(_get(e, "rate", 0.0), "links"),
            victims_min=e_lo, victims_max=e_hi,
            block_pm=_rate_pm(_get(e, "block", 0.0), "links block"),
            delay_min=dl_lo, delay_max=dl_hi,
            loss_pm_min=int(round(lp_lo * 1000)),
            loss_pm_max=int(round(lp_hi * 1000)))
    s = _get(dist, "skew")
    if s is not None:
        v_lo, v_hi = _range(_get(s, "victims", 1), "skew victims", 1,
                            n_nodes)
        r_lo, r_hi = _range(_get(s, "range", [1.0, 1.0]), "skew range",
                            MIN_RATE, MAX_RATE, cast=float)
        skew = LaneFuzz(
            rate_pm=_rate_pm(_get(s, "rate", 0.0), "skew"),
            victims_min=v_lo, victims_max=v_hi,
            rate64_min=max(1, int(round(r_lo * NEUTRAL_RATE))),
            rate64_max=max(1, int(round(r_hi * NEUTRAL_RATE))))
    m = _get(dist, "membership")
    if m is not None:
        v_lo, v_hi = _range(_get(m, "victims", 1),
                            "membership victims", 1, n_nodes - 1)
        membership = LaneFuzz(
            rate_pm=_rate_pm(_get(m, "rate", 0.0), "membership"),
            victims_min=v_lo, victims_max=v_hi)
    plan_every = _get(dist, "snapshot_every", 1)
    every = int(snapshot_every if snapshot_every is not None
                else (1 if plan_every is None else plan_every))
    fz = FuzzConfig(enabled=True, windows_min=w_lo, windows_max=w_hi,
                    gap_min=g_lo, gap_max=g_hi, dur_min=d_lo,
                    dur_max=d_hi, crash=crash, links=links, skew=skew,
                    membership=membership)
    return FaultConfig(enabled=True, stop_tick=int(stop_tick),
                       snapshot_every=every, fuzz=fz,
                       n_nodes=int(n_nodes))


# --- the schedule draw, batched over instances ------------------------------


def _randint(key: torch.Tensor, sub: int, shape, lo: int, hi: int
             ) -> torch.Tensor:
    """``randint(fold_in(key, sub), shape, lo, hi)``."""
    return rng.randint(rng.fold_in(key, sub), shape, lo, hi)


def _roll(key: torch.Tensor, pm: int) -> torch.Tensor:
    """The integer bernoulli of a window's lane: ``randint(fold_in(key,
    0), (), 0, 1000) < pm``."""
    return _randint(key, 0, (), 0, 1000) < pm


def _victims(kw: torch.Tensor, lane: LaneFuzz, N: int) -> torch.Tensor:
    """Per window ``kw [..., 2]``: a random ``[lo, hi]``-sized node set
    ``[..., N]`` (a permutation's first ``nv`` entries), gated by the
    lane's roll."""
    act = _roll(kw, lane.rate_pm)
    nv = _randint(kw, 1, (), lane.victims_min, lane.victims_max + 1)
    perm = rng.permutation(rng.fold_in(kw, 2), N).long()
    chosen = torch.arange(N, device=kw.device) < nv[..., None]
    mask = torch.zeros(chosen.shape, dtype=torch.bool, device=kw.device)
    return mask.scatter(-1, perm, chosen) & act[..., None]


def draw_schedule(keys: torch.Tensor, fx: FaultConfig, n_nodes: int
                  ) -> FaultSchedule:
    """Every instance's schedule from its key ``keys [I, 2]``: the JAX
    ``draw_schedule`` per key, bit for bit. Each lane folds its own
    subkey, so adding a lane never perturbs another lane's draws; a
    lane's per-window keys ``fold_in(k_lane, w)`` are ``split(k_lane,
    W)``."""
    fz = fx.fuzz
    N = n_nodes
    W = fz.windows_max
    E = fz.links.victims_max
    I = keys.shape[0]
    dev = keys.device
    k_win, k_crash, k_links, k_skew, k_mem = rng.fold_in(
        keys[:, None, :], torch.arange(1, 6, device=dev)).unbind(1)

    n_w = _randint(k_win, 0, (), fz.windows_min, fz.windows_max + 1)
    gaps = _randint(k_win, 1, (W,), fz.gap_min, fz.gap_max + 1)
    durs = _randint(k_win, 2, (W,), fz.dur_min, fz.dur_max + 1)
    untils = torch.stack([gaps, durs], dim=2).reshape(I, 2 * W).cumsum(
        dim=1).to(torch.int32)
    # windows past the drawn count exist but carry no faults
    w_live = torch.arange(W, device=dev)[None, :] < n_w[:, None]

    if fz.has_crash:
        crash = _victims(rng.split(k_crash, W), fz.crash, N) \
            & w_live[..., None]
    else:
        crash = torch.zeros((I, W, N), dtype=torch.bool, device=dev)

    if fz.has_links:
        lf = fz.links
        kw = rng.split(k_links, W)                            # [I, W, 2]
        act = _roll(kw, lf.rate_pm)
        ne = _randint(kw, 1, (), lf.victims_min, lf.victims_max + 1)
        live_e = (torch.arange(E, device=dev) < ne[..., None]) \
            & act[..., None]
        dst = _randint(kw, 2, (E,), 0, N)
        srcr = _randint(kw, 3, (E,), 0, N - 1)
        src = srcr + (srcr >= dst).to(torch.int32)    # directed, never self
        blk = (_randint(kw, 4, (E,), 0, 1000) < lf.block_pm)
        dly = _randint(kw, 5, (E,), lf.delay_min, lf.delay_max + 1)
        pm = _randint(kw, 6, (E,), lf.loss_pm_min, lf.loss_pm_max + 1)
        z = (live_e & w_live[..., None]).to(torch.int32)
        e_dst, e_src = dst, src
        e_blk, e_dly, e_pm = blk.to(torch.int32) * z, dly * z, pm * z
    else:
        e_dst = e_src = e_blk = e_dly = e_pm = torch.zeros(
            (I, W, 0), dtype=torch.int32, device=dev)

    if fz.has_skew:
        sf = fz.skew
        kw = rng.split(k_skew, W)
        victim = _victims(kw, sf, N) & w_live[..., None]
        rate = _randint(kw, 3, (N,), sf.rate64_min, sf.rate64_max + 1)
        skew = torch.where(victim, rate, NEUTRAL_RATE).to(torch.int32)
    else:
        skew = torch.full((I, W, N), NEUTRAL_RATE, dtype=torch.int32,
                          device=dev)

    if fz.has_membership:
        mem_out = _victims(rng.split(k_mem, W), fz.membership, N) \
            & w_live[..., None]
    else:
        mem_out = torch.zeros((I, W, N), dtype=torch.bool, device=dev)

    return FaultSchedule(untils=untils, crash=crash, edge_dst=e_dst,
                         edge_src=e_src, edge_block=e_blk,
                         edge_delay=e_dly, edge_loss_pm=e_pm, skew=skew,
                         mem_out=mem_out)


def _at(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Window ``w [I]``'s row of a per-window leaf ``x [I, W, ...]``."""
    idx = w.reshape((-1, 1) + (1,) * (x.dim() - 2)).expand(
        (x.shape[0], 1) + x.shape[2:])
    return x.gather(1, idx)[:, 0]


def _edge_plane(dst, src, val, NT: int) -> torch.Tensor:
    """``zeros([I, NT, NT]).at[i, dst, src].max(val)`` for edges ``[I,
    E]`` (duplicate edges merge by max): one scatter-max on the
    flattened ``dst * NT + src`` index."""
    I = dst.shape[0]
    plane = torch.zeros((I, NT * NT), dtype=torch.int32, device=dst.device)
    return plane.scatter_reduce(1, (dst * NT + src).long(), val,
                                reduce="amax").reshape(I, NT, NT)


def schedule_planes(sched: FaultSchedule, fx: FaultConfig, cfg, t: int
                    ) -> FaultPlanes:
    """Tick ``t``'s planes ``[I, ...]`` from every instance's schedule,
    merged as ``engine._planes_np`` merges a plan's (crashed and parked
    receivers block whole rows, duplicate edges max-merge), so a
    schedule replayed as a plan selects value-identical planes."""
    fz = fx.fuzz
    N = cfg.n_nodes
    NT = cfg.n_total
    W = fz.windows_max
    I = sched.untils.shape[0]
    dev = sched.untils.device

    def window_at(tt: int):
        ph = torch.searchsorted(
            sched.untils, torch.full((I, 1), tt, dtype=torch.int32,
                                     device=dev), right=True)[:, 0]
        in_win = (ph % 2 == 1) & (ph < 2 * W) & (tt < fx.stop_tick)
        return (ph // 2).clamp(0, W - 1), in_win

    w, in_window = window_at(t)
    out = {}
    if fz.has_crash:
        out["crash"] = _at(sched.crash, w) & in_window[:, None]
    if fz.has_membership:
        out["member"] = ~(_at(sched.mem_out, w) & in_window[:, None])
        # tick 0 reads its timeline at -1, the leading gap: a zero-gap
        # first window parks its victims from the very start
        w_p, in_win_p = window_at(t - 1)
        out["member_prev"] = ~(_at(sched.mem_out, w_p) & in_win_p[:, None])
    link_blocks = fz.has_links and fz.links.block_pm > 0
    if fz.has_links:
        act = in_window.to(torch.int32)[:, None]
        dst, src = _at(sched.edge_dst, w), _at(sched.edge_src, w)
    if fz.has_crash or link_blocks or fz.has_membership:
        if link_blocks:
            block = _edge_plane(dst, src, _at(sched.edge_block, w) * act,
                                NT) == 1
        else:
            block = torch.zeros((I, NT, NT), dtype=torch.bool, device=dev)
        held = torch.zeros((I, NT), dtype=torch.bool, device=dev)
        if fz.has_crash:
            # a dead process hears nobody, servers and clients
            held[:, :N] |= out["crash"]
        if fz.has_membership:
            held[:, :N] |= ~out["member"]
        out["block"] = block | held[:, :, None]
    if fz.has_links:
        out["delay"] = _edge_plane(dst, src, _at(sched.edge_delay, w) * act,
                                   NT)
        out["loss_pm"] = _edge_plane(dst, src,
                                     _at(sched.edge_loss_pm, w) * act, NT)
    if fz.has_skew:
        rate = torch.where(in_window[:, None], _at(sched.skew, w),
                           NEUTRAL_RATE)
        out["t_nodes"] = torch.div(t * rate, NEUTRAL_RATE,
                                   rounding_mode="floor").to(torch.int32)
    return FaultPlanes(**out)


# --- host-side reconstruction (seed -> schedule -> plan) ---------------------


def reconstruct_schedule(fx: FaultConfig, n_nodes: int, seed: int,
                         instance_id: int) -> FaultSchedule:
    """Re-draw one instance's schedule on the CPU, numpy leaves without
    the instance axis: the key chain ``init_carry`` uses,
    ``fold_in(fold_in(PRNGKey(seed), RNG_PURPOSE), instance_id)``."""
    key = rng.fold_in(rng.fold_in(rng.prng_key(int(seed)), RNG_PURPOSE),
                      int(instance_id))
    sched = draw_schedule(key[None], fx, n_nodes)
    return FaultSchedule(*(x[0].numpy() for x in sched))


def schedule_to_plan(sched: FaultSchedule, fx: FaultConfig
                     ) -> Dict[str, Any]:
    """Lower one instance's drawn schedule (numpy leaves, no instance
    axis) to a deterministic ``--fault-plan`` dict whose compiled
    planes are value-identical at every tick: windows with no drawn
    content merge into the healthy timeline, windows entirely past the
    final-heal ``stop_tick`` are dropped, and all quantities roundtrip
    exactly (integer ticks, per-mille loss, 64th-quantized skew)."""
    fz = fx.fuzz
    W = fz.windows_max
    untils = np.asarray(sched.untils).reshape(-1)
    phases: List[Dict[str, Any]] = []
    prev = 0
    pending_add: List[int] = []   # membership restores owed to the
    #                               next emitted phase
    for w in range(W):
        gap_end = int(untils[2 * w])
        win_end = int(untils[2 * w + 1])
        if gap_end >= int(fx.stop_tick) or win_end <= gap_end:
            continue
        ph: Dict[str, Any] = {}
        victims = np.nonzero(np.asarray(sched.crash[w]))[0]
        if victims.size:
            ph["crash"] = [int(v) for v in victims]
        removed = np.nonzero(np.asarray(sched.mem_out[w]))[0]
        if removed.size:
            ph["remove"] = [int(v) for v in removed]
        edges = []
        for e in range(np.asarray(sched.edge_dst).shape[1]):
            blk = int(sched.edge_block[w][e])
            dly = int(sched.edge_delay[w][e])
            pm = int(sched.edge_loss_pm[w][e])
            if not (blk or dly or pm):
                continue      # value-neutral edge: a no-op on the device
            edges.append({"dst": int(sched.edge_dst[w][e]),
                          "src": int(sched.edge_src[w][e]),
                          "block": bool(blk), "delay": dly,
                          "loss": pm / 1000.0})
        if edges:
            ph["links"] = edges
        skew = {str(n): int(r) / NEUTRAL_RATE
                for n, r in enumerate(np.asarray(sched.skew[w]))
                if int(r) != NEUTRAL_RATE}
        if skew:
            ph["skew"] = skew
        # the previous removal window's victims rejoin at its end tick
        # (the start of whatever phase comes next)
        if pending_add:
            if gap_end > prev:
                phases.append({"until": gap_end, "add": pending_add})
            else:
                # zero-width gap: the rejoin rides the next window phase
                # itself (membership_walk applies add, then remove)
                ph["add"] = pending_add
            pending_add = []
        if not ph:
            continue          # contentless window: pure healthy time
        if gap_end > prev and (not phases
                               or int(phases[-1]["until"]) < gap_end):
            phases.append({"until": gap_end})
        phases.append({"until": win_end, **ph})
        prev = win_end
        if removed.size:
            pending_add = [int(v) for v in removed]
    if not phases:
        return {}             # an all-healthy draw IS the empty plan
    return {"snapshot_every": int(fx.snapshot_every), "phases": phases}


def reconstruct_plan(fx: FaultConfig, n_nodes: int, seed: int,
                     instance_id: int) -> Dict[str, Any]:
    """seed + instance id -> the instance's concrete schedule as a
    deterministic plan dict (``{}`` when the draw was all-healthy)."""
    return schedule_to_plan(
        reconstruct_schedule(fx, n_nodes, seed, instance_id), fx)


def plan_weight(plan: Dict[str, Any],
                n_nodes: Optional[int] = None) -> Tuple[int, int]:
    """(fault phases, total victims) of a plan dict: the shrinker's
    minimality metric. Membership removals count as victims (an
    absolute ``members`` set once, and only where it removes a node:
    a restore is a heal, ``spec.membership_heal_phases``); rejoin
    ``add`` events weigh nothing."""
    if not plan:
        return 0, 0
    heals = membership_heal_phases(plan, n_nodes)
    n_phases = 0
    victims = 0
    for i, ph in enumerate(plan.get("phases", ())):
        c = len(ph.get("crash") or [])
        e = len(ph.get("links") or [])
        s = len(ph.get("skew") or {})
        m = len(ph.get("remove") or []) \
            + (1 if ph.get("members") is not None
               and i not in heals else 0)
        if c or e or s or m:
            n_phases += 1
            victims += c + e + s + m
    return n_phases, victims


# --- fleet summaries ----------------------------------------------------------


def fleet_windows(fx: FaultConfig, n_nodes: int, seed: int,
                  instance_ids) -> Dict[str, np.ndarray]:
    """The whole fleet's drawn windows on the host: ``starts``/``ends``
    ``[I, W]`` (ends clipped to the final-heal ``stop_tick``) plus
    per-lane activity masks, from one batched re-draw on the CPU."""
    key = rng.fold_in(rng.prng_key(int(seed)), RNG_PURPOSE)
    ids = torch.as_tensor(np.asarray(instance_ids, np.int32))
    sched = FaultSchedule(*(x.numpy() for x in draw_schedule(
        rng.fold_in(key[None, :], ids), fx, n_nodes)))
    starts = sched.untils[:, 0::2]
    ends = np.minimum(sched.untils[:, 1::2], int(fx.stop_tick))
    if sched.edge_dst.shape[-1]:
        links = ((sched.edge_block + sched.edge_delay + sched.edge_loss_pm)
                 > 0).any(axis=-1)
    else:
        links = np.zeros(starts.shape, bool)
    live = ends > starts
    return {"starts": starts, "ends": ends,
            "crash": sched.crash.any(axis=-1) & live,
            "links": links & live,
            "skew": (sched.skew != NEUTRAL_RATE).any(axis=-1) & live,
            "membership": sched.mem_out.any(axis=-1) & live}


def span_counters(win: Dict[str, np.ndarray], t0: int,
                  ticks: int) -> Dict[str, int]:
    """The heartbeat's per-chunk fault-fuzz record: how many instances
    have a fault window overlapping ``[t0, t0 + ticks)``, per lane."""
    t1 = int(t0) + max(1, int(ticks))
    ov = (win["starts"] < t1) & (win["ends"] > int(t0))
    out = {"schedules-active": int(
        (ov & (win["crash"] | win["links"] | win["skew"]
               | win["membership"]))
        .any(axis=1).sum())}
    for lane in ("crash", "links", "skew", "membership"):
        out[lane] = int((ov & win[lane]).any(axis=1).sum())
    return out


def fleet_coverage(win: Dict[str, np.ndarray]) -> Dict[str, int]:
    """Schedule-space coverage: distinct schedules drawn and fault
    windows per lane."""
    sig = np.concatenate(
        [win["starts"], win["ends"],
         win["crash"].astype(np.int32), win["links"].astype(np.int32),
         win["skew"].astype(np.int32),
         win["membership"].astype(np.int32)], axis=1)
    return {
        "instances": int(sig.shape[0]),
        "distinct-schedules": int(np.unique(sig, axis=0).shape[0]),
        "crash-windows": int(win["crash"].sum()),
        "link-windows": int(win["links"].sum()),
        "skew-windows": int(win["skew"].sum()),
        "membership-windows": int(win["membership"].sum()),
    }


def fuzz_summary(fx: FaultConfig) -> Dict[str, Any]:
    """The run's distribution block."""
    fz = fx.fuzz
    lanes = [name for name, on in (("crash-restart", fz.has_crash),
                                   ("link-degradation", fz.has_links),
                                   ("clock-skew", fz.has_skew),
                                   ("membership", fz.has_membership))
             if on]
    return {"lanes": lanes,
            "windows": [fz.windows_min, fz.windows_max],
            "gap": [fz.gap_min, fz.gap_max],
            "duration": [fz.dur_min, fz.dur_max],
            "snapshot-every": int(fx.snapshot_every),
            "stop-tick": int(fx.stop_tick)}
