"""Vectorized CRDT gossip models: broadcast, g-set, pn- and g-counter.

Counterpart of ``maelstrom_tpu/models/crdt.py`` (legacy handle/tick
protocol), batched over a leading node axis. Each node keeps its whole
CRDT state in fixed lanes and each tick, with probability
``gossip_prob``, pushes it to one random topology neighbour; a merge is
a lattice join (bitwise OR of a set's bitmask words, pointwise max of a
counter table). The element domain is capped: 64 set elements in two
int32 words, so an element's bit 31 is ``INT32_MIN`` in its word.
"""

from __future__ import annotations

import torch

from .. import rng, wire, xla_math
from ..checkers import device_summary as ds
from ..runtime import EV_INFO, EV_OK, Model, op_rows
from ..topology import adjacency

# message types
T_ADD = 1        # broadcast / add(element) / add(delta)
T_ADD_OK = 2
T_READ = 3
T_READ_OK = 4
T_GOSSIP = 5     # anti-entropy state push (no reply)

F_ADD = 1
F_READ = 2

_I32 = torch.int32


def _sel(pred: torch.Tensor, a, b) -> torch.Tensor:
    """``jnp.where`` on int32 rows: ``pred [B]`` over ``[B, ...]``."""
    if isinstance(a, torch.Tensor):
        pred = pred.reshape(pred.shape + (1,) * (a.dim() - pred.dim()))
    return torch.where(pred, a, b).to(_I32)


def gossip_out(row_body: torch.Tensor, node_idx: torch.Tensor,
               keys: torch.Tensor, cfg, params: torch.Tensor,
               gossip_prob: float) -> torch.Tensor:
    """One anti-entropy push per node ``[B, 1, L]``: with probability
    ``gossip_prob``, a T_GOSSIP row carrying ``row_body [B, n]`` to one
    random neighbour (the first maximum of uniform draws over the
    adjacency row); a node without neighbours sends nothing. The JAX
    draws: ``k_fire, k_peer = split(key)``, ``uniform(k_fire)``,
    ``uniform(k_peer, (N,))``, here in one threefry call."""
    N = cfg.n_nodes
    bits = rng.random_bits(rng.split(keys, 2), (N,))          # [B, 2, N]
    fire = rng.uniform_from_bits(bits[:, 0, 0]) < xla_math.f32(gossip_prob)
    nbrs = params[node_idx.long()]                             # [B, N]
    g = rng.uniform_from_bits(bits[:, 1])
    peer = torch.where(nbrs, g, -1.0).argmax(dim=-1)
    out = torch.zeros((node_idx.shape[0], 1, cfg.lanes), dtype=_I32,
                      device=keys.device)
    out[:, 0, wire.VALID] = (fire & nbrs.any(dim=-1)).to(_I32)
    out[:, 0, wire.DEST] = peer.to(_I32)
    out[:, 0, wire.TYPE] = T_GOSSIP
    out[:, 0, wire.BODY:wire.BODY + row_body.shape[1]] = row_body
    return out


class _GossipModel(Model):
    """What the set and counter models share: the topology params, the
    gossip tick, and the add/read client vocabulary."""

    max_out = 1
    tick_out = 1
    gossip_prob = 0.5          # P(gossip to one random neighbor per tick)
    idempotent_fs = (F_READ,)

    def make_params(self, n_nodes: int, device=None):
        return torch.from_numpy(adjacency(self.topology, n_nodes)).to(device)

    def tick(self, row, node_idx, t, keys, cfg, params):
        return row, gossip_out(row.reshape(row.shape[0], -1), node_idx,
                               keys, cfg, params, self.gossip_prob)

    def _add_draws(self, keys):
        """``k1, k2 = split(key)``: ``uniform(k1)`` and the two 32-bit
        draws of ``randint(k2, ...)``, in one call: ``[I, C, 3]``."""
        ks = rng.split(keys, 2)
        halves = rng.split(ks[..., 1, :], 2)
        return rng.random_bits(torch.cat([ks[..., :1, :], halves], dim=-2))

    def sample_final_op(self, keys, uniq, cfg, params=None):
        return op_rows(F_READ, torch.zeros_like(uniq))

    def encode_request(self, op, msg_id, client_idx, keys, cfg,
                       params=None):
        dest = rng.randint(keys, (), 0, cfg.n_nodes)
        is_add = op[..., 0] == F_ADD
        return wire.make_msg(
            src=0, dest=dest, type_=_sel(is_add, T_ADD, T_READ),
            msg_id=msg_id, body=(_sel(is_add, op[..., 1], 0),),
            body_lanes=self.body_lanes, netid=cfg.netid,
            batch_shape=op.shape[:-1], device=op.device)


class GossipSetModel(_GossipModel):
    """Grow-only set over a 64-element domain held as a 2-word bitmask;
    the base of both the g-set and the broadcast workloads (they differ
    only in op naming)."""

    name = "g-set"
    checker_name = "set-full"
    n_values = 64              # element domain (2 x int32 bitmask words)
    body_lanes = 2
    add_f_name = "add"

    def __init__(self, topology: str = "grid"):
        self.topology = topology

    def init_state(self, n_nodes, keys):
        # the seen-bitmask words
        return torch.zeros(keys.shape[:-1] + (2,), dtype=_I32,
                           device=keys.device)

    @staticmethod
    def _set_bit(words: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``words [B, 2]`` with bit ``v % 32`` of word ``v // 32`` set;
        ``1 << 31`` wraps to ``INT32_MIN`` as in int32."""
        bit = rng._wrap_i32(torch.ones_like(v, dtype=torch.int64)
                            << (v % 32).long())
        word = torch.arange(2, device=v.device) == (v // 32)[:, None]
        return torch.where(word, words | bit[:, None], words)

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        mtype = msg[:, wire.TYPE]
        added = self._set_bit(row, msg[:, wire.BODY].clamp(
            0, self.n_values - 1))
        merged = row | msg[:, wire.BODY:wire.BODY + 2]
        row = _sel(mtype == T_ADD, added,
                   _sel(mtype == T_GOSSIP, merged, row))
        read_body = _sel(mtype == T_READ, row, 0)
        out = wire.reply_rows(msg, (mtype == T_ADD) | (mtype == T_READ),
                              _sel(mtype == T_ADD, T_ADD_OK, T_READ_OK),
                              cfg.lanes, (read_body[:, 0], read_body[:, 1]))
        return row, out

    def summary_step(self, summ, node_state, events, cfg, params=None):
        """The grow-only set lane, per instance: frontier = the popcount
        of the nodes' union bitmask (monotone: a g-set only grows); hash
        = the union words. Model flag: a read completing while some view
        still differs from node 0's inside the unsettled window (it may
        show a lost element to the host checker)."""
        # [I, N, 2, 32]: every bit of every word, the union by max over N
        bit = torch.arange(32, device=node_state.device)
        bits = ((node_state.long() & 0xFFFFFFFF)[..., None] >> bit) & 1
        union_bits = bits.amax(dim=1)                          # [I, 2, 32]
        frontier = union_bits.flatten(1).sum(dim=1)
        union = (union_bits << bit).sum(dim=-1)
        unsettled = (node_state[:, 1:] != node_state[:, :1]).flatten(1).any(
            dim=1)
        h = union[:, 0] * ds.HASH_C1 + union[:, 1] * ds.HASH_C2
        summ, stale = ds.stale_read_window(summ, events, unsettled, F_READ)
        return ds.fold_frontier(summ, frontier, h, model_flag=stale)

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        bits = self._add_draws(keys)
        is_add = rng.uniform_from_bits(bits[..., 0]) < xla_math.f32(0.5)
        # a distinct-ish element per client op; collisions wrap the domain
        # and re-add an existing element, which is harmless
        pick = rng.randint_from_bits(bits[..., 1], bits[..., 2], 0,
                                     cfg.n_clients)
        element = torch.remainder(uniq * cfg.n_clients + pick,
                                  self.n_values)
        return _sel(is_add, op_rows(F_ADD, element),
                    op_rows(F_READ, torch.zeros_like(uniq)))

    def decode_reply(self, op, msg, cfg, params=None):
        mtype = msg[..., wire.TYPE]
        ok = (mtype == T_ADD_OK) | (mtype == T_READ_OK)
        is_read = mtype == T_READ_OK
        # reads: the bitmask words in a, b; adds: the element in a
        return _sel(ok, EV_OK, EV_INFO), torch.stack(
            [_sel(is_read, msg[..., wire.BODY], op[..., 1]),
             _sel(is_read, msg[..., wire.BODY + 1], 0),
             torch.zeros_like(op[..., 0])], dim=-1)

    # --- host-side decoding -------------------------------------------------

    @staticmethod
    def _decode_bitmask(a, b):
        out = []
        for w, word in enumerate((a, b)):
            word &= 0xFFFFFFFF
            for bit in range(32):
                if word & (1 << bit):
                    out.append(w * 32 + bit)
        return out

    def invoke_record(self, f, a, b, c):
        if f == F_ADD:
            return {"f": self.add_f_name, "value": int(a)}
        return {"f": "read", "value": None}

    def complete_record(self, f, a, b, c, etype):
        if f == F_ADD:
            return {"f": self.add_f_name, "value": int(a)}
        if etype == EV_OK:
            return {"f": "read", "value": self._decode_bitmask(int(a),
                                                               int(b))}
        return {"f": "read", "value": None}

    def checker(self):
        from ..checkers.set_full import set_full_checker
        add_f = self.add_f_name
        return lambda history, opts: set_full_checker(history, add_f=add_f)


class BroadcastModel(GossipSetModel):
    """Broadcast-workload face of the gossip set (messages == elements)."""
    name = "broadcast"
    add_f_name = "broadcast"


class PNCounterModel(_GossipModel):
    """PN-counter: per-node (plus, minus) pairs, gossiped whole and merged
    by pointwise max; a read returns sum(plus) - sum(minus). The add
    delta and the read value are clamped to their declared ranges
    (value-identical on every honest trace)."""

    name = "pn-counter"
    checker_name = "pn-counter"
    allow_negative = True
    add_abs_max = 5
    counter_abs_max = 1 << 27

    def __init__(self, n_nodes_hint: int = 5, topology: str = "total"):
        # the body carries the full counter table: 2 lanes per node
        self.n_nodes_hint = n_nodes_hint
        self.topology = topology
        self.body_lanes = max(2, 2 * n_nodes_hint)

    def make_params(self, n_nodes: int, device=None):
        if n_nodes != self.n_nodes_hint:
            raise ValueError(f"{type(self).__name__} built for "
                             f"{self.n_nodes_hint} nodes, run has "
                             f"{n_nodes}")
        return super().make_params(n_nodes, device)

    def init_state(self, n_nodes, keys):
        # [N, (plus, minus)] per node
        return torch.zeros(keys.shape[:-1] + (n_nodes, 2), dtype=_I32,
                           device=keys.device)

    def handle(self, row, node_idx, msg, t, keys, cfg, params):
        N = cfg.n_nodes
        mtype = msg[:, wire.TYPE]
        lo = -self.add_abs_max if self.allow_negative else 0
        delta = msg[:, wire.BODY].clamp(lo, self.add_abs_max)
        bump = torch.stack([delta.clamp(min=0), (-delta).clamp(min=0)],
                           dim=-1)                             # [B, 2]
        own = torch.arange(N, device=row.device) == node_idx[:, None]
        added = torch.where(own[..., None], row + bump[:, None, :], row)
        table = msg[:, wire.BODY:wire.BODY + 2 * N].reshape(-1, N, 2)
        merged = torch.maximum(row, table)
        row = _sel(mtype == T_ADD, added,
                   _sel(mtype == T_GOSSIP, merged, row))
        # int32 sums and difference, wrapping as in JAX
        value = (row[..., 0].sum(dim=-1).to(_I32)
                 - row[..., 1].sum(dim=-1).to(_I32)).clamp(
            -self.counter_abs_max, self.counter_abs_max)
        out = wire.reply_rows(msg, (mtype == T_ADD) | (mtype == T_READ),
                              _sel(mtype == T_ADD, T_ADD_OK, T_READ_OK),
                              cfg.lanes, (_sel(mtype == T_READ, value, 0),))
        return row, out

    def summary_step(self, summ, node_state, events, cfg, params=None):
        """The counter-table lane over ``[I, viewer N, origin N, 2]``:
        frontier = the per-origin max over viewers, summed over origins
        and both polarities (adds and max-merges only grow entries);
        hash = that max table. Model flag: some viewer's entry for origin
        o above o's own (views only propagate by gossip from the origin),
        or a read completing while some view lags its origin inside the
        unsettled window (the interval checker's stale read)."""
        best = node_state.amax(dim=1)                          # [I, N, 2]
        frontier = best.flatten(1).sum(dim=1)
        n = node_state.shape[1]
        diag = torch.arange(n, device=node_state.device)
        own = node_state[:, diag, diag]                        # [I, N, 2]
        inflated = (node_state > own[:, None]).flatten(1).any(dim=1)
        unsettled = (node_state < own[:, None]).flatten(1).any(dim=1)
        flat = best.flatten(1).long()
        pos = torch.arange(flat.shape[1], device=flat.device)
        h = (((flat * ds.HASH_C1 + pos) & 0xFFFFFFFF)
             * ((pos << 1) | 1)).sum(dim=1)
        summ, stale = ds.stale_read_window(summ, events, unsettled, F_READ)
        return ds.fold_frontier(summ, frontier, h,
                                model_flag=inflated | stale)

    # --- client side --------------------------------------------------------

    def sample_op(self, keys, uniq, cfg, params=None):
        bits = self._add_draws(keys)
        is_add = rng.uniform_from_bits(bits[..., 0]) < xla_math.f32(0.5)
        lo = -self.add_abs_max if self.allow_negative else 0
        delta = rng.randint_from_bits(bits[..., 1], bits[..., 2], lo,
                                      self.add_abs_max + 1)
        return _sel(is_add, op_rows(F_ADD, delta),
                    op_rows(F_READ, torch.zeros_like(uniq)))

    def decode_reply(self, op, msg, cfg, params=None):
        mtype = msg[..., wire.TYPE]
        ok = (mtype == T_ADD_OK) | (mtype == T_READ_OK)
        z = torch.zeros_like(op[..., 0])
        return _sel(ok, EV_OK, EV_INFO), torch.stack(
            [_sel(mtype == T_READ_OK, msg[..., wire.BODY], op[..., 1]),
             z, z], dim=-1)

    def invoke_record(self, f, a, b, c):
        if f == F_ADD:
            return {"f": "add", "value": int(a)}
        return {"f": "read", "value": None}

    def complete_record(self, f, a, b, c, etype):
        if f == F_ADD:
            return {"f": "add", "value": int(a)}
        if etype == EV_OK:
            return {"f": "read", "value": int(a)}
        return {"f": "read", "value": None}

    def checker(self):
        from ..checkers.pn_counter import pn_counter_checker
        return lambda history, opts: pn_counter_checker(history)


class GCounterModel(PNCounterModel):
    name = "g-counter"
    allow_negative = False
