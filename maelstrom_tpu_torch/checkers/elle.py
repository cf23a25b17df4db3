"""Transactional anomaly detection — an Elle-style checker.

Fills the role jepsen's Elle plays for the reference's txn workloads
(src/maelstrom/workload/txn_list_append.clj via jepsen.tests.cycle.append,
txn_rw_register.clj via cycle.wr): infer per-key version orders from
observed reads, build a transaction dependency graph, and hunt for
anomalies.

Implemented (the core of Elle's catalogue for these workloads):

- **G1a aborted read** — a committed read observes a value from a failed
  transaction.
- **G1b intermediate read** — a read observes a non-final state of a key
  written multiple times by one transaction.
- **duplicate / reorder inconsistencies** in list-append reads (two reads
  of a key disagree on the order of their common prefix, or an element
  appears twice) — these invalidate the version-order inference and are
  reported as ``incompatible-order``.
- **lost append** — an acknowledged append absent from the longest
  observed read of its key when later reads exist.
- **dependency cycles** — Tarjan SCC over the union of:
  ``wr`` (T2 read something T1 wrote), ``ww`` (version order, list-append
  only), ``rw`` anti-dependency (T1 read a state missing v, T2 wrote v as
  its successor), per-process session order, and (for strict
  serializability) real-time order. Cycles are classified G0/G1c/G2-item
  by their edge mix, and which classes *fail* the check depends on
  ``consistency_models`` (read-committed < read-atomic < serializable <
  strict-serializable), mirroring the reference's
  ``--consistency-models`` flag (core.clj:160-165).

Histories use the reference's micro-op encoding: op value is a list of
``[f, k, v]`` with f in {"append", "r"} (list-append) or {"w", "r"}
(rw-register).

A copy of ``maelstrom_tpu/checkers/elle.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Set, Tuple

# anomaly class -> weakest consistency model that forbids it
_FORBIDDEN_BY = {
    "G0": "read-uncommitted",        # ww cycles
    "G1a": "read-committed",
    "G1b": "read-committed",
    "G1c": "read-committed",         # ww/wr cycles
    # under snapshot isolation every dependency cycle must contain two
    # ADJACENT rw edges (Fekete et al. 2005) — so a single-rw cycle
    # (G-single) or a multi-rw cycle with no two rw edges adjacent
    # (G-nonadjacent) refutes SI, while classic write skew (two
    # adjacent rw edges) is SI-legal and only fails serializable+
    "G-single": "snapshot-isolation",
    "G-nonadjacent": "snapshot-isolation",
    "G2-item": "serializable",       # >=1 rw edge
    "internal": "read-atomic",       # a txn contradicting its own writes
    "realtime": "strict-serializable",
    "incompatible-order": "read-uncommitted",
    # a read observing a value that NO transaction — committed, failed,
    # or indeterminate — ever wrote is data corruption, invalid at any
    # model (Elle's :unwritten / garbage-read discipline)
    "unwritten-read": "read-uncommitted",
    # two external reads of one key within one txn disagreeing: legal
    # non-repeatable read at read-committed, fractured at read-atomic+
    "fractured-read": "read-atomic",
    # detection of lost appends relies on real-time ordering ("a read
    # that STARTED after the append completed misses it") — under plain
    # serializability such a read may legally serialize earlier, so this
    # only fails strict models; true serializability losses surface as
    # ww/wr/rw cycles instead (including the unobserved-append rw edges
    # below: a read of k missing acked value v must serialize before
    # v's append — lists only grow)
    "lost-append": "strict-serializable",
}

_MODEL_ORDER = ["read-uncommitted", "read-committed", "read-atomic",
                "snapshot-isolation", "serializable",
                "strict-serializable"]


def _model_leq(a: str, b: str) -> bool:
    return _MODEL_ORDER.index(a) <= _MODEL_ORDER.index(b)


class _Graph:
    def __init__(self):
        self.edges: Dict[int, Dict[int, Set[str]]] = defaultdict(
            lambda: defaultdict(set))

    def add(self, a: int, b: int, kind: str):
        if a != b:
            self.edges[a][b].add(kind)

    def sccs(self) -> List[List[int]]:
        """Tarjan's strongly-connected components (iterative)."""
        index: Dict[int, int] = {}
        low: Dict[int, int] = {}
        on_stack: Set[int] = set()
        stack: List[int] = []
        out: List[List[int]] = []
        counter = [0]
        nodes = set(self.edges)
        for tos in self.edges.values():
            nodes.update(tos)

        for root in nodes:
            if root in index:
                continue
            work = [(root, iter(self.edges.get(root, {})))]
            index[root] = low[root] = counter[0]
            counter[0] += 1
            stack.append(root)
            on_stack.add(root)
            while work:
                v, it = work[-1]
                advanced = False
                for w in it:
                    if w not in index:
                        index[w] = low[w] = counter[0]
                        counter[0] += 1
                        stack.append(w)
                        on_stack.add(w)
                        work.append((w, iter(self.edges.get(w, {}))))
                        advanced = True
                        break
                    elif w in on_stack:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                work.pop()
                if work:
                    pv = work[-1][0]
                    low[pv] = min(low[pv], low[v])
                if low[v] == index[v]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w)
                        comp.append(w)
                        if w == v:
                            break
                    if len(comp) > 1:
                        out.append(comp)
        return out

    def cycle_kinds(self, comp: List[int]) -> Set[str]:
        cset = set(comp)
        kinds: Set[str] = set()
        for a in comp:
            for b, ks in self.edges.get(a, {}).items():
                if b in cset:
                    kinds.update(ks)
        return kinds

    def shortest_path(self, src: int, dst: int, cset: Set[int],
                      avoid_kind: Optional[str] = None
                      ) -> Optional[List[int]]:
        """BFS path src -> dst inside ``cset``; edges whose ONLY kinds
        include ``avoid_kind`` are usable iff they also carry another
        kind (an edge is excluded only when avoid_kind is its sole
        justification)."""
        from collections import deque
        prev: Dict[int, int] = {src: src}
        q = deque([src])
        while q:
            v = q.popleft()
            if v == dst:
                path = [v]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                return path[::-1]
            for w, ks in self.edges.get(v, {}).items():
                if w not in cset or w in prev:
                    continue
                if avoid_kind is not None and ks <= {avoid_kind}:
                    continue
                prev[w] = v
                q.append(w)
        return None

    def minimal_cycle(self, comp: List[int]
                      ) -> Optional[Tuple[List[int], List[Set[str]]]]:
        """Find a short explanatory cycle in the SCC, preferring the
        *weakest* anomaly shape (Elle's discipline: report the most
        specific cycle, not the whole SCC): first a cycle with no rw
        edges, then exactly-one-rw (G-single witness), else any cycle.
        Returns (nodes, edge kinds between consecutive nodes, cyclic)."""
        cset = set(comp)

        def close(path):
            kinds = []
            for a, b in zip(path, path[1:] + path[:1]):
                kinds.append(set(self.edges[a][b]))
            return path, kinds

        # Bounded search: one BFS per candidate edge is O(V+E); cap the
        # candidates per class so a dense worst-case SCC (badly broken
        # system -> most txns in one component) stays O(K*(V+E)) instead
        # of O(E*(V+E)). The first cycle found in the strongest class
        # wins — any witness cycle explains the anomaly.
        MAX_TRIES = 64

        # (a) rw-free cycle: edge (u, v) without rw + path v -> u
        # avoiding rw-only edges
        tries = 0
        for u in comp:
            for v, ks in self.edges.get(u, {}).items():
                if v not in cset or ks <= {"rw"}:
                    continue
                tries += 1
                if tries > MAX_TRIES:
                    break
                p = self.shortest_path(v, u, cset, avoid_kind="rw")
                if p is not None:
                    return close([u] + p[:-1])
            if tries > MAX_TRIES:
                break
        # (b) exactly one rw edge: for each rw edge (u, v), rw-free
        # path v -> u
        tries = 0
        for u in comp:
            for v, ks in self.edges.get(u, {}).items():
                if v not in cset or "rw" not in ks:
                    continue
                tries += 1
                if tries > MAX_TRIES:
                    break
                p = self.shortest_path(v, u, cset, avoid_kind="rw")
                if p is not None:
                    return close([u] + p[:-1])
            if tries > MAX_TRIES:
                break
        # (c) any cycle at all (>= 2 rw edges)
        for u in comp:
            for v in self.edges.get(u, {}):
                if v not in cset:
                    continue
                p = self.shortest_path(v, u, cset)
                if p is not None:
                    return close([u] + p[:-1])
        return None


def _classify_cycle(kinds: Set[str], rw_edge_count: int = 2) -> str:
    rw = "rw" in kinds
    realtime_only = kinds <= {"realtime", "process"}
    if realtime_only:
        return "realtime"
    if rw:
        # Elle distinguishes exactly-one-rw cycles (G-single) from
        # multi-rw G2-item. When called from the minimal-cycle path the
        # count is exact; the SCC-level fallback passes 2, so an SCC
        # that is genuinely single-rw would be labeled G2-item there —
        # sound (never over-claims) but under-reports at the
        # snapshot-isolation level, where G-single is forbidden and
        # G2-item is not. The fallback is unreachable for real SCCs
        # (minimal_cycle always finds a witness); this note documents
        # the dependency.
        return "G-single" if rw_edge_count == 1 else "G2-item"
    if "wr" in kinds:
        return "G1c"
    return "G0"


def _collect_txns(history) -> Tuple[List[dict], List[dict]]:
    """Returns (committed, failed) txns: each a dict with
    index/process/ops (completed micro-ops for committed, invoked for
    failed/info)."""
    from .linearizable import pairs
    committed, failed = [], []
    for p in pairs(history):
        inv, comp = p["invoke"], p["complete"]
        if inv.get("process") == "nemesis" or inv.get("f") != "txn":
            continue
        if comp is not None and comp["type"] == "ok":
            committed.append({"id": len(committed), "index": inv["index"],
                              "end": comp["index"],
                              "process": inv["process"],
                              "ops": comp["value"]})
        elif comp is None or comp["type"] in ("fail", "info"):
            failed.append({"process": inv["process"],
                           "ops": inv["value"],
                           "definite_fail": (comp is not None
                                             and comp["type"] == "fail")})
    return committed, failed


def check_list_append(history,
                      consistency_model: str = "strict-serializable",
                      cycle_search_budget: int = 20_000) -> dict:
    committed, failed = _collect_txns(history)
    anomalies: Dict[str, List[Any]] = defaultdict(list)

    # appended values must be unique per key for inference; the workload
    # generator guarantees this
    writer: Dict[Tuple[Any, Any], Tuple[int, int]] = {}   # (k,v)->(txn,pos)
    failed_writes: Set[Tuple[Any, Any]] = set()
    maybe_writes: Set[Tuple[Any, Any]] = set()   # indeterminate (info)
    for t in failed:
        for op in t["ops"] or []:
            if op[0] == "append":
                (failed_writes if t["definite_fail"]
                 else maybe_writes).add((op[1], op[2]))
    for t in committed:
        for pos, op in enumerate(t["ops"]):
            if op[0] == "append":
                writer[(op[1], op[2])] = (t["id"], pos)

    # within-txn consistency: a read of k must be (shared external
    # prefix) + (this txn's own appends to k so far) — the txn sees its
    # own writes ("internal", Adya's intra-transactional reads) and all
    # its external reads of k come from ONE snapshot ("fractured-read")
    for t in committed:
        own: Dict[Any, List[Any]] = defaultdict(list)
        ext_prefix: Dict[Any, List[Any]] = {}
        for op in t["ops"]:
            k = op[1]
            if op[0] == "append":
                own[k].append(op[2])
                continue
            if op[2] is None:
                continue
            vs, suffix = list(op[2]), own[k]
            if suffix and vs[-len(suffix):] != suffix:
                anomalies["internal"].append(
                    {"key": k, "read": vs, "own-appends": list(suffix),
                     "txn": t["ops"]})
                continue
            prefix = vs[:len(vs) - len(suffix)]
            if k in ext_prefix and ext_prefix[k] != prefix:
                anomalies["fractured-read"].append(
                    {"key": k, "reads": [ext_prefix[k], prefix],
                     "txn": t["ops"]})
            else:
                ext_prefix[k] = prefix

    # reads indexed by key once; the anomaly scans below iterate only
    # same-key reads (linear-ish, not quadratic in the whole history)
    reads_of_key: Dict[Any, List[Tuple[int, List[Any]]]] = \
        defaultdict(list)   # k -> [(txn id, values)]
    for t in committed:
        for op in t["ops"]:
            if op[0] == "r" and op[2] is not None:
                reads_of_key[op[1]].append((t["id"], list(op[2])))

    # same-txn append order is version order: observing two of one txn's
    # appends to k out of program order contradicts any execution
    for t in committed:
        by_key: Dict[Any, List[Any]] = defaultdict(list)
        for op in t["ops"]:
            if op[0] == "append":
                by_key[op[1]].append(op[2])
        for k, vs in by_key.items():
            if len(vs) < 2:
                continue
            for _, read_vs in reads_of_key.get(k, ()):
                pos = {repr(v): i for i, v in enumerate(read_vs)}
                seen = [repr(v) for v in vs if repr(v) in pos]
                if any(pos[a] > pos[b]
                       for a, b in zip(seen, seen[1:])):
                    anomalies["incompatible-order"].append(
                        {"key": k, "read": read_vs,
                         "appended-in-order": vs})

    # per-key longest read; order compatibility between reads
    longest: Dict[Any, List[Any]] = {}
    for t in committed:
        for op in t["ops"]:
            if op[0] != "r" or op[2] is None:
                continue
            k, vs = op[1], list(op[2])
            if len(set(map(repr, vs))) != len(vs):
                anomalies["incompatible-order"].append(
                    {"key": k, "read": vs, "why": "duplicate element"})
                continue
            cur = longest.get(k, [])
            shorter, longer = sorted([vs, cur], key=len)
            if longer[:len(shorter)] != shorter:
                anomalies["incompatible-order"].append(
                    {"key": k, "read": vs, "longest": cur})
            if len(vs) > len(cur):
                longest[k] = vs

    # G1a: reads observing failed appends; G1b: intermediate reads — a
    # read list that contains another txn's append to k but NOT that
    # txn's LATER append to the same k saw a mid-transaction state
    for t in committed:
        for op in t["ops"]:
            if op[0] != "r" or op[2] is None:
                continue
            k = op[1]
            seen = set(map(repr, op[2]))
            for v in op[2]:
                if (k, v) in failed_writes:
                    anomalies["G1a"].append({"key": k, "value": v,
                                             "txn": t["ops"]})
                elif (k, v) not in writer and (k, v) not in maybe_writes:
                    anomalies["unwritten-read"].append(
                        {"key": k, "value": v, "txn": t["ops"]})
                w = writer.get((k, v))
                if w is not None and w[0] != t["id"]:
                    wt = committed[w[0]]
                    later = [o[2] for i, o in enumerate(wt["ops"])
                             if i > w[1] and o[0] == "append"
                             and o[1] == k]
                    if any(repr(v2) not in seen for v2 in later):
                        anomalies["G1b"].append({"key": k, "value": v})

    # lost appends: acked append missing from reads that *began* after
    # the append completed (a read overlapping the append in real time
    # may legally serialize before it, so it owes us nothing)
    reads_by_key = defaultdict(list)
    for t in committed:
        for op in t["ops"]:
            if op[0] == "r" and op[2] is not None:
                reads_by_key[op[1]].append((t["index"], list(op[2])))
    for (k, v), (tid, _) in writer.items():
        t = committed[tid]
        later = [vs for (inv, vs) in reads_by_key.get(k, [])
                 if inv > t["end"]]
        if later:
            newest = max(later, key=len)
            if v not in newest:
                anomalies["lost-append"].append({"key": k, "value": v})

    # dependency graph
    g = _Graph()
    version_pos: Dict[Tuple[Any, Any], int] = {}
    for k, vs in longest.items():
        for i, v in enumerate(vs):
            version_pos[(k, v)] = i
    # ww: consecutive appends in a key's version order
    for k, vs in longest.items():
        for i in range(len(vs) - 1):
            a = writer.get((k, vs[i]))
            b = writer.get((k, vs[i + 1]))
            if a and b:
                g.add(a[0], b[0], "ww")
    for t in committed:
        for op in t["ops"]:
            if op[0] != "r" or op[2] is None:
                continue
            k, vs = op[1], op[2]
            # wr: we read the last element's writer
            if vs:
                w = writer.get((k, vs[-1]))
                if w:
                    g.add(w[0], t["id"], "wr")
            # rw: the next version after our read state was written by
            # someone else
            order = longest.get(k, [])
            if len(vs) < len(order):
                nxt = writer.get((k, order[len(vs)]))
                if nxt:
                    g.add(t["id"], nxt[0], "rw")
    # generalized anti-dependency: lists only grow, so a read of k
    # missing acked value v must serialize before v's append — even
    # when v never shows up in ANY read (the version-order inference
    # can't place it, but the edge is still sound). This is what turns
    # an unobserved lost append into a visible cycle when its writer is
    # otherwise ordered before the reader (VERDICT r4 next #6).
    # Iterates same-key reads only (reads_of_key above).
    seen_of_key: Dict[Any, List[Tuple[int, Set[str]]]] = defaultdict(list)
    for k, rds in reads_of_key.items():
        for rid, vs in rds:
            seen_of_key[k].append((rid, set(map(repr, vs))))
    for (k, v), (wid, _) in writer.items():
        rv = repr(v)
        for rid, seen in seen_of_key.get(k, ()):
            if rid != wid and rv not in seen:
                g.add(rid, wid, "rw")
    return _finish(g, committed, anomalies, consistency_model,
                   cycle_search_budget=cycle_search_budget)


def _finish(g: _Graph, committed: List[dict],
            anomalies: Dict[str, List[Any]], consistency_model: str,
            cycle_search_budget: int = 20_000,
            filter_timeout: bool = False) -> dict:
    """Shared tail of both checkers: session + realtime edges, SCC cycle
    classification, model-filtered verdict.

    ``cycle_search_budget`` caps the total SCC nodes examined for
    explanatory cycles; past it, remaining SCCs are reported as a
    ``cycle-search-timeout`` pseudo-anomaly (Elle's behavior on dense
    graphs) which makes an otherwise-clean verdict ``"unknown"`` — a
    skipped search proves nothing either way. ``filter_timeout``
    reproduces the reference rw-register workload's hack of dropping
    that pseudo-anomaly entirely (txn_rw_register.clj:138-150: "we're
    probably gonna hit a zillion SCCs causing cycle search timeouts,
    but none of them are relevant to us")."""
    by_process = defaultdict(list)
    for t in committed:
        by_process[t["process"]].append(t)
    for ts in by_process.values():
        ts.sort(key=lambda t: t["index"])
        for a, b in zip(ts, ts[1:]):
            g.add(a["id"], b["id"], "process")
    # realtime order (strict serializability only): a -> b iff a
    # completed before b was invoked. Interval reduction preserving
    # reachability: for each a, link every b whose invoke lies in
    # (a.end, e_min], where e_min is the earliest end among txns invoked
    # after a.end — any later c is reachable through the txn achieving
    # e_min (its end < c.invoke gives the next realtime hop). Linking
    # only the FIRST successor would miss b's concurrent with it.
    if consistency_model == "strict-serializable":
        import bisect
        invokes = sorted(committed, key=lambda t: t["index"])
        inv_keys = [t["index"] for t in invokes]
        # suffix minimum of end over invoke order
        suffix_min_end = [0] * (len(invokes) + 1)
        suffix_min_end[len(invokes)] = 1 << 62
        for i in range(len(invokes) - 1, -1, -1):
            suffix_min_end[i] = min(invokes[i]["end"],
                                    suffix_min_end[i + 1])
        for a in committed:
            lo = bisect.bisect_right(inv_keys, a["end"])
            if lo >= len(invokes):
                continue
            e_min = suffix_min_end[lo]
            j = lo
            while j < len(invokes) and invokes[j]["index"] <= e_min:
                b = invokes[j]
                if b["id"] != a["id"]:
                    g.add(a["id"], b["id"], "realtime")
                j += 1

    budget = cycle_search_budget
    skipped_sccs = 0
    largest_skipped = 0
    for comp in g.sccs():
        if budget <= 0:
            skipped_sccs += 1
            largest_skipped = max(largest_skipped, len(comp))
            continue
        budget -= len(comp)
        cyc = g.minimal_cycle(comp)
        if cyc is None:   # unreachable for a real SCC; keep the old path
            kinds = g.cycle_kinds(comp)
            cls = _classify_cycle(kinds, 2)
            anomalies[cls].append(
                {"txns": [committed[i]["ops"] for i in comp[:6]],
                 "edges": sorted(kinds)})
            continue
        nodes, edge_kinds = cyc
        # an edge "needs" rw only when rw is its sole justification; a
        # cycle needing no rw edge classifies by its other kinds even if
        # some edge also happens to carry rw
        rw_needed = sum(1 for ks in edge_kinds if ks <= {"rw"})
        all_kinds = set().union(*edge_kinds)
        eff_kinds = all_kinds - {"rw"} if rw_needed == 0 else all_kinds
        cls = _classify_cycle(eff_kinds, max(rw_needed, 1)
                              if "rw" in eff_kinds else rw_needed)
        if cls == "G2-item":
            # SI refinement on the witness cycle: >=2 required-rw edges
            # with NO two cyclically adjacent refutes snapshot
            # isolation (G-nonadjacent). Witness-based, so an SCC that
            # ALSO contains a nonadjacent cycle may still report
            # G2-item — sound (never over-claims), possibly
            # under-reports at the SI level.
            pos = [i for i, ks in enumerate(edge_kinds)
                   if ks <= {"rw"}]
            L = len(edge_kinds)
            if len(pos) >= 2 and not any(
                    (a + 1) % L == b
                    for a in pos for b in pos if a != b):
                cls = "G-nonadjacent"
        # minimal cycle with per-edge explanations (Elle-style: each
        # step says WHY txn a must precede txn b)
        steps = []
        for i, ks in enumerate(edge_kinds):
            a = nodes[i]
            b = nodes[(i + 1) % len(nodes)]
            steps.append({"txn": committed[a]["ops"],
                          "then": committed[b]["ops"],
                          "because": sorted(ks)})
        anomalies[cls].append(
            {"cycle-length": len(nodes), "steps": steps[:8],
             "edges": sorted(all_kinds)})

    if skipped_sccs and not filter_timeout:
        anomalies["cycle-search-timeout"].append(
            {"sccs-skipped": skipped_sccs,
             "largest-scc": largest_skipped,
             "budget": cycle_search_budget})
    bad = {a: v for a, v in anomalies.items()
           if a != "cycle-search-timeout"
           and _model_leq(_FORBIDDEN_BY.get(a, "read-uncommitted"),
                          consistency_model)}
    valid = not bad
    if valid and "cycle-search-timeout" in anomalies:
        valid = "unknown"   # unsearched SCCs prove nothing either way
    return {
        "valid?": valid,
        "anomaly-types": sorted(anomalies),
        "anomalies": {k: v[:8] for k, v in bad.items()},
        "txn-count": len(committed),
        "consistency-model": consistency_model,
    }


def check_rw_register(history,
                      consistency_model: str = "strict-serializable",
                      cycle_search_budget: int = 20_000) -> dict:
    """rw-register anomalies. Writes are unique per key, so wr edges are
    exact. Version order per key is inferred only from sound facts —
    write-follows-read within a committed txn (the reference's
    ``:wfr-keys? true``, txn_rw_register.clj:162-168) and the initial
    nil version preceding every written version — from which ww and
    generalized anti-dependency (rw) edges follow. Session + realtime
    edges are added in :func:`_finish`. Never false-positive; a sound
    subset of Elle's rw-register analysis (it won't invent version
    orders it cannot prove)."""
    committed, failed = _collect_txns(history)
    anomalies: Dict[str, List[Any]] = defaultdict(list)

    writer: Dict[Tuple[Any, Any], int] = {}
    failed_writes: Set[Tuple[Any, Any]] = set()
    maybe_writes: Set[Tuple[Any, Any]] = set()   # indeterminate (info)
    for t in failed:
        for op in t["ops"] or []:
            if op[0] == "w":
                (failed_writes if t["definite_fail"]
                 else maybe_writes).add((op[1], op[2]))
    for t in committed:
        for op in t["ops"]:
            if op[0] == "w":
                writer[(op[1], op[2])] = t["id"]

    g = _Graph()
    # G1b: reading a non-final write of another txn
    final_write: Dict[Tuple[int, Any], Any] = {}
    for w_t in committed:
        for op in w_t["ops"]:
            if op[0] == "w":
                final_write[(w_t["id"], op[1])] = op[2]
    # readers[(k, v)] = txns that externally observed version v of k
    # (v None = the initial unwritten version); a fractured txn that
    # observes several versions of one key is recorded against each
    readers: Dict[Tuple[Any, Any], Set[int]] = defaultdict(set)
    vo_pairs: Set[Tuple[Any, Any, Any]] = set()   # (k, v1, v2): v1 < v2
    for t in committed:
        # single pass per txn: external reads (before own writes), the
        # write-follows-read version-order pairs (wfr: last external
        # read of k before this txn's FIRST write of k orders those
        # versions), and internal consistency (a read after this txn's
        # own write must see it)
        last_read: Dict[Any, Any] = {}
        wrote: Dict[Any, Any] = {}
        for op in t["ops"]:
            f, k, v = op[0], op[1], op[2]
            if f == "r":
                if k in wrote:
                    if v != wrote[k]:
                        anomalies["internal"].append(
                            {"key": k, "expected": wrote[k],
                             "read": v, "txn": t["ops"]})
                    continue
                if k in last_read and last_read[k] != v:
                    # two external reads of one key from one txn must
                    # come from a single snapshot
                    anomalies["fractured-read"].append(
                        {"key": k, "reads": [last_read[k], v],
                         "txn": t["ops"]})
                last_read[k] = v
                readers[(k, v)].add(t["id"])
                if v is not None:
                    if (k, v) in failed_writes:
                        anomalies["G1a"].append({"key": k, "value": v})
                    elif (k, v) not in writer \
                            and (k, v) not in maybe_writes:
                        anomalies["unwritten-read"].append(
                            {"key": k, "value": v, "txn": t["ops"]})
                    w = writer.get((k, v))
                    if w is not None and w != t["id"]:
                        g.add(w, t["id"], "wr")
                        if final_write.get((w, k)) != v:
                            anomalies["G1b"].append({"key": k,
                                                     "value": v})
            else:
                if k not in wrote and k in last_read:
                    vo_pairs.add((k, last_read[k], v))
                wrote[k] = v

    # version-order inference (sound, never guessed):
    #   - wfr: a txn that read version v1 of k and then wrote v2 orders
    #     v1 < v2
    #   - the initial (nil) version precedes every written version
    # From v1 < v2 follow ww (writer(v1) -> writer(v2)) and the
    # generalized anti-dependency rw: ANY txn that observed v1 must
    # precede the writer of any later version (it would have seen it
    # otherwise) — this is what exposes write skew and other G2-item /
    # G-single cycles the wr/session edges alone cannot.
    writers_by_key: Dict[Any, Set[int]] = defaultdict(set)
    for (k, v), w in writer.items():
        writers_by_key[k].add(w)
    # realtime version-order inference (strict only; Elle's realtime
    # version orders): a committed writer of (k, v') that COMPLETED
    # before a read of (k, v) was INVOKED must serialize before the
    # reader; the reader observes v, so v' cannot lie between v's
    # writer and the reader — v' < v in k's version order
    if consistency_model == "strict-serializable":
        for (k, v), rs in list(readers.items()):
            if v is None or writer.get((k, v)) is None:
                continue
            w = writer[(k, v)]
            for (k2, v2), w2 in writer.items():
                if k2 != k or v2 == v or w2 == w:
                    continue
                if any(committed[w2]["end"] < committed[r]["index"]
                       for r in rs if r != w2):
                    vo_pairs.add((k, v2, v))
    # a nil-reader that itself writes k precedes every other writer of
    # k (its nil read pins it before them all), so ITS version is k's
    # FIRST: every other version follows it — vo pairs, hence ww +
    # generalized-rw edges (e.g. a later reader of this first version
    # anti-depends on every other writer of k). Sound ONLY under a
    # serialization assumption (at read-committed the nil read may be
    # legally stale while the write installs late), so gated like the
    # realtime inference above — weaker models must not inherit ww
    # edges that would classify as G0 there.
    if _model_leq("serializable", consistency_model):
        own_write: Dict[Tuple[Any, int], List[Any]] = defaultdict(list)
        for (k, v), w in writer.items():
            own_write[(k, w)].append(v)
        for (k, v), rs in list(readers.items()):
            if v is not None:
                continue
            for r in rs:
                for v2 in own_write.get((k, r), ()):
                    for w3 in writers_by_key.get(k, ()):
                        if w3 != r:
                            for v3 in own_write.get((k, w3), ()):
                                vo_pairs.add((k, v2, v3))
    for k, v1, v2 in vo_pairs:
        w2 = writer.get((k, v2))
        if w2 is None:
            continue
        w1 = writer.get((k, v1)) if v1 is not None else None
        if w1 is not None and w1 != w2:
            g.add(w1, w2, "ww")
        for r in readers.get((k, v1), ()):
            if r != w2:
                g.add(r, w2, "rw")
    # nil precedes everything: its readers anti-depend on every writer
    for (k, v), rs in list(readers.items()):
        if v is not None:
            continue
        for w2 in writers_by_key.get(k, ()):
            for r in rs:
                if r != w2:
                    g.add(r, w2, "rw")

    # filter_timeout: reference parity — the rw-register workload drops
    # cycle-search timeouts (txn_rw_register.clj:138-150)
    return _finish(g, committed, anomalies, consistency_model,
                   cycle_search_budget=cycle_search_budget,
                   filter_timeout=True)
