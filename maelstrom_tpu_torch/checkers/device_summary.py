"""Device verdict lanes: per-instance screening for the host checker farm.

Counterpart of ``maelstrom_tpu/checkers/device_summary.py``, batched over
the instance axis. Every instance carries a fixed-shape int32 summary
row (``Carry.check_summary``, ``[I, N_LANES]``) updated inside the tick,
and with ``check_mode="device"`` the host farm (``checkers/pool.py``)
checks only the instances whose FLAGS lane is nonzero or whose
invariants tripped; every other recorded instance gets a synthesized
``{"valid?": True, "checked-by": "device-summary"}`` verdict. A flag is
a screen, never a verdict: false positives cost farm work.

Lanes (int32; the cumulative counters wrap, as int32 does in XLA):

- ``L_FLAGS``  bitmask of ``FLAG_*`` suspicions;
- ``L_HASH``   the model's committed-prefix rolling hash;
- ``L_FRONTIER`` the committed watermark (model-defined, monotone on
  every correct trajectory);
- ``L_READ_FRONTIER`` the running max of every frontier seen: a frontier
  below it raises ``FLAG_REGRESSION``;
- ``L_STALE``  ticks the frontier spent below it;
- ``L_OK``/``L_FAIL``/``L_INFO`` completions per outcome, from the
  tick's completion slot;
- ``L_SENT``/``L_DELIVERED`` the instance's sends and deliveries;
- ``L_SCRATCH`` model-private state (the CRDT models' 31-tick
  unsettled-window shift register).

``Model.summary_step`` (``runtime.py``) folds one tick of the model's
frontier, hash and divergence witness through :func:`fold_frontier`;
the default is the identity, and such models keep zero flags.

Wrapping: the JAX functions multiply and sum int32 values that are
meant to overflow. Here the products and sums run in int64 on values
reduced to their low 32 bits, and each result is cast back to int32
(two's-complement truncation), which keeps the same low 32 bits XLA's
int32 arithmetic does. Comparisons only ever see the int32 results.
"""

from __future__ import annotations

import torch

# lane indices ---------------------------------------------------------------

N_LANES = 11
(L_FLAGS, L_HASH, L_FRONTIER, L_READ_FRONTIER, L_STALE,
 L_OK, L_FAIL, L_INFO, L_SENT, L_DELIVERED, L_SCRATCH) = range(N_LANES)

# L_FLAGS bits
FLAG_DIVERGED = 1    # committed-prefix divergence (model summary_step)
FLAG_REGRESSION = 2  # frontier fell below the read frontier
FLAG_MODEL = 4       # model-specific condition (kafka committed past the
                     # log, counter views above their source, a CRDT
                     # read served while a replica lagged)

# the event wire's type lane and outcome codes (runtime.EV_*), mirrored
# so this module never imports the runtime that imports it
_EV_TYPE = 0
_EV_OK, _EV_FAIL, _EV_INFO = 2, 3, 4

# odd multipliers of the rolling hash (int32 wraparound is the modulus)
HASH_C1 = 40503
HASH_C2 = 999983

_I32 = torch.int32
_M32 = 0xFFFFFFFF


def init_summary(n_instances: int, device=None) -> torch.Tensor:
    """A fresh ``[I, N_LANES]`` summary block."""
    return torch.zeros((n_instances, N_LANES), dtype=_I32, device=device)


def prefix_terms(terms: torch.Tensor, bodies: torch.Tensor) -> torch.Tensor:
    """Each log slot's hash term, ``[..., LOGN]`` int64 holding the low 32
    bits of the int32 ``(term * C1 + sum(body) * C2 + pos) * (2 pos +
    1)``: ``terms [..., LOGN]``, ``bodies [..., LOGN, E]``. The position
    enters through a per-slot odd multiplier, so swapped entries hash
    differently."""
    pos = torch.arange(terms.shape[-1], device=terms.device)
    contrib = ((terms.long() * HASH_C1 + bodies.sum(dim=-1) * HASH_C2
                + pos) & _M32)
    return contrib * ((pos << 1) | 1)


def masked_hash(terms64: torch.Tensor, in_prefix: torch.Tensor
                ) -> torch.Tensor:
    """The int32 sum of :func:`prefix_terms` over the slots in
    ``in_prefix`` (last axis)."""
    return torch.where(in_prefix, terms64, 0).sum(dim=-1).to(_I32)


def prefix_hash(terms, bodies, in_prefix) -> torch.Tensor:
    """Order-sensitive int32 hash of a masked log prefix, batched over
    the leading axes: ``terms [..., LOGN]``, ``bodies [..., LOGN, E]``,
    ``in_prefix [..., LOGN]`` bool -> ``[...]``."""
    return masked_hash(prefix_terms(terms, bodies), in_prefix)


def fold_frontier(summ, frontier, hash_val, diverged=None,
                  model_flag=None) -> torch.Tensor:
    """Fold one tick's frontier and hash ``[I]`` (and the optional
    divergence and model-flag witnesses ``[I]`` bool) into the summary
    rows ``[I, N_LANES]``: store the watermark and hash, advance the
    read frontier, and raise the regression flag (and count the tick)
    when the watermark fell below anything seen before."""
    frontier = frontier.to(_I32)
    read_f = summ[:, L_READ_FRONTIER]
    regressed = frontier < read_f
    flags = summ[:, L_FLAGS] | (regressed.to(_I32) * FLAG_REGRESSION)
    if diverged is not None:
        flags = flags | (diverged.to(_I32) * FLAG_DIVERGED)
    if model_flag is not None:
        flags = flags | (model_flag.to(_I32) * FLAG_MODEL)
    head = torch.stack([flags, hash_val.to(_I32), frontier,
                        torch.maximum(read_f, frontier),
                        summ[:, L_STALE] + regressed.to(_I32)], dim=1)
    return torch.cat([head, summ[:, L_OK:]], dim=1)


def update_summary(model, summ, node_state, events, n_sent, n_del, cfg,
                   params=None):
    """One tick of the fleet's summary block: the model's batched
    ``summary_step``, then the availability and net-stat twins from the
    full-fleet events ``[I, C, 2, 2 + V]`` (the completion slot, slot 0)
    and the per-instance send and delivery counts ``[I]``. None stays
    None (lanes off)."""
    if summ is None:
        return None
    summ = model.summary_step(summ, node_state, events, cfg, params)
    et = events[:, :, 0, _EV_TYPE]
    counts = torch.stack(
        [(et == _EV_OK).sum(dim=1), (et == _EV_FAIL).sum(dim=1),
         (et == _EV_INFO).sum(dim=1), n_sent.long(), n_del.long()],
        dim=1).to(_I32)
    return torch.cat([summ[:, :L_OK], summ[:, L_OK:L_SCRATCH] + counts,
                      summ[:, L_SCRATCH:]], dim=1)


def stale_read_window(summ, events, unsettled, read_f: int):
    """The CRDT stale-read screen: shift this tick's ``unsettled [I]``
    witness (some replica lags the acknowledged state) into the
    L_SCRATCH window register (31 ticks) and return ``(summ', stale)``,
    ``stale [I]`` True when a read (op code ``read_f``) completed ok
    this tick with an unsettled tick inside the window: the window
    covers the reply's flight from the serve tick to the completion."""
    win = (((summ[:, L_SCRATCH].long() << 1) | unsettled.long())
           & 0x7FFFFFFF).to(_I32)
    done = events[:, :, 0]
    read_done = ((done[..., _EV_TYPE] == _EV_OK)
                 & (done[..., 1] == read_f)).any(dim=1)
    summ = torch.cat([summ[:, :L_SCRATCH], win[:, None]], dim=1)
    return summ, read_done & (win != 0)


def flagged_mask(violations, check_summary):
    """``[I]`` bool: instances needing host confirmation — invariants
    tripped or a summary flag raised. Takes torch tensors (the chunk
    scans) and numpy arrays (the harness's routing) alike."""
    flagged = violations > 0
    if check_summary is not None:
        flagged = flagged | (check_summary[:, L_FLAGS] != 0)
    return flagged


def summary_bytes_per_tick(n_instances: int) -> int:
    """Device memory traffic the lanes add per tick (the block read and
    written, counted once, as the JAX package reports it)."""
    return int(n_instances) * N_LANES * 4
