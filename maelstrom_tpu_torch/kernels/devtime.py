"""A kernel's device time per launch, apart from the host's issue time.

Timing back-to-back Python calls with CUDA events measures how fast the
host issues them when a launch takes less device time than its host
call. :func:`device_ms` reads instead the kernel's own durations, as
CUPTI records them under ``torch.profiler``, over many launches. With
``flush_l2`` every launch is preceded by a read of a buffer twice the
size of the card's 50 MB L2 cache, so the kernel finds its inputs in
device memory, as the memory bound of a kernel counts them; without it
an input that fits in L2 stays there from one launch to the next.
Needs a CUDA card.
"""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

L2_FLUSH_BYTES = 128 << 20


def device_ms(fn: Callable[[], object], kernel_name: str, iters: int = 200,
              flush_l2: bool = True, max_sessions: int = 5) -> float:
    """Mean device duration in ms of the kernels whose name contains
    ``kernel_name``, over at least ``iters`` recorded launches, after
    three warm-up calls. Each profiling session makes ``iters`` calls of
    ``fn`` (each must launch exactly one such kernel). CUPTI can lose
    some of a session's kernel records (an H100 once gave 182 of 200),
    so further sessions run until ``iters`` durations are in hand, at
    most ``max_sessions`` in all."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms needs a CUDA card")
    flush = (torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda") if flush_l2 else None)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    durs: list[float] = []
    for _ in range(max_sessions):
        got = _session_us(fn, kernel_name, iters, flush)
        if len(got) > iters:
            raise RuntimeError(f"device_ms: {len(got)} kernels named "
                               f"{kernel_name!r} for {iters} calls")
        durs += got
        if len(durs) >= iters:
            return sum(durs) / len(durs) / 1e3
    raise RuntimeError(f"device_ms: {len(durs)} kernels named "
                       f"{kernel_name!r} recorded in {max_sessions} "
                       f"sessions of {iters} calls")


def _session_us(fn, kernel_name, iters, flush) -> list[float]:
    """Durations in us of the matching kernels CUPTI recorded over one
    profiling session of ``iters`` calls of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.max()      # reads evict; no dirty lines left behind
            fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() for e in prof.events()
            if str(e.device_type).endswith("CUDA")
            and kernel_name in e.name]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
