"""The in-tick flight recorder: fixed-shape int32 telemetry threaded
through the carry.

Counterpart of ``maelstrom_tpu/telemetry/recorder.py``. Per instance it
accumulates NetStats totals, inbox/pool high-water marks, a log2-bucket
histogram of client ticks-to-ack, partition epochs and the first
invariant-trip tick; a fleet-summed time series (one row per ``stride``
ticks) rides in a fixed ``[n_windows, SERIES_LANES]`` buffer.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

SERIES_NAMES = ("delivered", "sent", "dropped-partition", "dropped-loss",
                "dropped-overflow", "invokes", "acks", "inflight")
SERIES_LANES = len(SERIES_NAMES)


class TelemetryConfig(NamedTuple):
    """Static telemetry parameters."""
    enabled: bool = True
    hist_buckets: int = 16   # log2 latency buckets
    stride: int = 64         # ticks per series window
    n_windows: int = 32      # ceil(n_ticks / stride)


class Telemetry(NamedTuple):
    """Per-instance recorder state (int32; ``[I]`` unless noted)."""
    sent: torch.Tensor
    delivered: torch.Tensor
    delivered_servers: torch.Tensor
    dropped_partition: torch.Tensor
    dropped_loss: torch.Tensor
    dropped_overflow: torch.Tensor
    invokes: torch.Tensor
    acks: torch.Tensor
    inbox_hwm: torch.Tensor
    pool_hwm: torch.Tensor
    partition_ticks: torch.Tensor
    nemesis_epochs: torch.Tensor
    partition_prev: torch.Tensor
    first_violation: torch.Tensor
    rpc_hist: torch.Tensor           # [I, hist_buckets]
    series: torch.Tensor             # [n_windows, SERIES_LANES]


def init_telemetry(n_instances: int, cfg: TelemetryConfig, device=None
                   ) -> Optional[Telemetry]:
    """Zeroed recorder state, or None when telemetry is off."""
    if not cfg.enabled:
        return None
    z = lambda: torch.zeros((n_instances,), dtype=torch.int32,
                            device=device)
    return Telemetry(
        sent=z(), delivered=z(), delivered_servers=z(),
        dropped_partition=z(), dropped_loss=z(), dropped_overflow=z(),
        invokes=z(), acks=z(), inbox_hwm=z(), pool_hwm=z(),
        partition_ticks=z(), nemesis_epochs=z(), partition_prev=z(),
        first_violation=torch.full((n_instances,), -1, dtype=torch.int32,
                                   device=device),
        rpc_hist=torch.zeros((n_instances, cfg.hist_buckets),
                             dtype=torch.int32, device=device),
        series=torch.zeros((cfg.n_windows, SERIES_LANES),
                           dtype=torch.int32, device=device),
    )


def latency_bucket(lat: torch.Tensor, cfg: TelemetryConfig) -> torch.Tensor:
    """Exact integer log2 bucket: the number of thresholds ``2^k`` (k in
    [1, hist_buckets)) that ``lat + 1`` reaches."""
    thresholds = 2 ** torch.arange(1, cfg.hist_buckets, dtype=torch.int32,
                                   device=lat.device)
    lat = lat.clamp(min=0)
    return ((lat[..., None] + 1) >= thresholds).sum(dim=-1).to(torch.int32)


def record_tick(tel: Telemetry, t: int, cfg: TelemetryConfig, *,
                n_sent, n_del, n_del_serv, n_dropp, n_lost, n_ovf,
                pool_occ, part_active, violated, ok_mask, invoke_mask,
                lat) -> Telemetry:
    """Fold one tick's deltas into the recorder. Per-instance ``n_*`` /
    ``pool_occ`` are int32 ``[I]``, ``part_active`` / ``violated`` bool
    ``[I]``, ``ok_mask`` / ``invoke_mask`` / ``lat`` ``[I, C]``."""
    i32 = torch.int32
    part_i = part_active.to(i32)
    viol = violated.to(i32)
    bucket = latency_bucket(lat, cfg)                          # [I, C]
    onehot = bucket[..., None] == torch.arange(
        cfg.hist_buckets, dtype=i32, device=bucket.device)
    hist_delta = (onehot & ok_mask[..., None]).sum(dim=1).to(i32)
    n_acks = ok_mask.sum(dim=1).to(i32)
    n_invokes = invoke_mask.sum(dim=1).to(i32)
    row = torch.stack([n_del.sum(), n_sent.sum(), n_dropp.sum(),
                       n_lost.sum(), n_ovf.sum(), n_invokes.sum(),
                       n_acks.sum(), pool_occ.sum()]).to(i32)
    window = min(t // cfg.stride, cfg.n_windows - 1)
    series = tel.series.clone()
    series[window] += row
    return Telemetry(
        sent=tel.sent + n_sent,
        delivered=tel.delivered + n_del,
        delivered_servers=tel.delivered_servers + n_del_serv,
        dropped_partition=tel.dropped_partition + n_dropp,
        dropped_loss=tel.dropped_loss + n_lost,
        dropped_overflow=tel.dropped_overflow + n_ovf,
        invokes=tel.invokes + n_invokes,
        acks=tel.acks + n_acks,
        inbox_hwm=torch.maximum(tel.inbox_hwm, n_del),
        pool_hwm=torch.maximum(tel.pool_hwm, pool_occ),
        partition_ticks=tel.partition_ticks + part_i,
        nemesis_epochs=tel.nemesis_epochs
        + part_i * (1 - tel.partition_prev),
        partition_prev=part_i,
        first_violation=torch.where(
            (tel.first_violation < 0) & (viol > 0),
            torch.full_like(tel.first_violation, t), tel.first_violation),
        rpc_hist=tel.rpc_hist + hist_delta,
        series=series,
    )
