"""Certified store of the kernel libraries the chunk dispatch launches.

Counterpart of ``maelstrom_tpu/tpu/aot_store.py``. JAX's store keeps
serialized XLA executables of the chunk dispatch, so that a run skips
trace and compile. The port traces nothing and compiles nothing per
run: the one binary its dispatch depends on is a kernel library, which
``kernels/build.py`` compiles with ``nvcc`` at first use. So this store
keeps **the kernel libraries the dispatch launches**, certified as JAX
certifies its executables, and a hit loads them without starting
``nvcc``: the port's seconds-to-first-tick on a fresh machine or a
fresh copy of the tree.

Keying is two-tier, as in JAX:

* the **store key** (the dispatch-time lookup) is a sha256 over what the
  host knows without recording anything: the canonical model and sim
  config, the carry's leaf shapes and dtypes, the static chunk
  arguments (length, event capacity, scan width, whether the chunk
  copies the fleet's NetStats), a digest of the dispatch's source files
  (:func:`source_digest`), the torch and CUDA versions and the device
  kind. Any of those drifting is a safe miss.
* the **certificate**, recorded in the entry's sidecar at populate time,
  is :func:`graph_digest` of the chunk dispatch's aten graph
  (``pipeline.issue_chunk``, or one shard's ``mesh.shard_chunk``)
  recorded on ``meta`` tensors at :data:`AOT_CHUNK_LEN` ticks by
  ``analysis/cost_model.py``'s recorder, beside the dispatch's
  collective census and a sha256 of each library the entry names.
  ``lint --aot`` (``analysis/aot_audit.py``) re-derives and checks them.

Layout: ``<root>/<key>.json`` is an entry's sidecar; ``<root>/lib/
<libkey>.so`` and ``.json`` a library and its sidecar, stored once per
(source hash, ``nvcc`` flags, toolchain, device kind) and shared by
every entry that launches it, so a new configuration pays no new
``nvcc``. A populate builds a library the store lacks with a real
``nvcc`` (``kernels.build.build_to``), even when ``build/kernels/``
holds it — the counterpart of JAX's ``_uncached_compile``. A hit reads
each library's bytes, checks them against the recorded sha256, writes
those bytes to a private file and ``dlopen``\\ s that copy
(``kernels.build.install``), so a file changed after the check is never
loaded. On the CPU the dispatch launches no kernel: an entry holds the
certificate and an empty library list. Writes are atomic (a temporary
file, then a rename).

``MAELSTROM_AOT=0`` is the kill switch; ``aot_store`` / ``--aot-store
DIR|auto|off`` picks the directory (``auto``: ``build/aot`` in the
checkout, which ``.gitignore`` lists). A load is refused by name, and
treated as a miss, when the entry was recorded under another torch or
CUDA version or device kind (the runtime face of EXE904) or a library's
bytes fail their sha256 (the runtime face of EXE901). Every other
failure leaves the run on its ordinary path: the store is an
accelerator, never a correctness dependency, and trajectories are the
same with it on, off, warm or cold.

JAX's EXE902 (donation lost in a stored executable) has no counterpart:
the port's executors donate nothing (``analysis/ir_lint.py``, JXP403).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sys
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

ENV_VAR = "MAELSTROM_AOT"
STORE_VERSION = 1

_PKG = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_PKG)

# `auto`: the store beside the kernel builds (build/ is gitignored)
DEFAULT_DIR = os.path.join(_REPO, "build", "aot")

# ticks of the chunk dispatch the certificate records (the shard and aot
# passes certify the same specialization)
AOT_CHUNK_LEN = 4

# the port's files that the chunk dispatch runs: the digest over them is
# the cheap (nothing recorded) drift guard in the store key; analysis/,
# campaign/, the CLI and the host-side telemetry never enter the dispatch
_SOURCES = ("runtime.py", "netsim.py", "pipeline.py", "rng.py",
            "xla_math.py", "wire.py", "telemetry/recorder.py", "parallel",
            "models", "faults", "checkers", "kernels", "csrc")
_SUFFIXES = (".py", ".cu")

_HEX = re.compile(r"0x[0-9a-fA-F]+")

_src_cache: Dict[str, str] = {}


def aot_enabled() -> bool:
    """``MAELSTROM_AOT=0`` kills every store consultation."""
    return os.environ.get(ENV_VAR, "").strip() != "0"


def resolve_store_dir(flag: Optional[str]) -> Optional[str]:
    """The effective store dir, or ``None`` when disabled: ``None`` or
    ``"auto"`` is :data:`DEFAULT_DIR`, ``"off"``/``"0"``/``""``
    disables, anything else is the directory. ``MAELSTROM_AOT=0`` wins
    over all."""
    if not aot_enabled():
        return None
    if flag is not None and str(flag).strip() in ("off", "0", ""):
        return None
    if flag is not None and str(flag).strip() != "auto":
        return os.path.abspath(str(flag))
    return DEFAULT_DIR


def source_digest() -> str:
    """sha256 over every source file the chunk dispatch runs
    (:data:`_SOURCES`). Part of the store key: an edited source is a
    store miss before anything is recorded. Cached per process."""
    cached = _src_cache.get(_PKG)
    if cached is not None:
        return cached
    h = hashlib.sha256()
    paths = []
    for sub in _SOURCES:
        base = os.path.join(_PKG, sub)
        if os.path.isfile(base):
            paths.append(base)
            continue
        for dirpath, dirnames, filenames in sorted(os.walk(base)):
            dirnames.sort()
            paths += [os.path.join(dirpath, fn) for fn in sorted(filenames)
                      if fn.endswith(_SUFFIXES)]
    for path in paths:
        h.update(os.path.relpath(path, _PKG).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    _src_cache[_PKG] = digest
    return digest


def _canon(x: Any) -> Any:
    """Canonical JSON-able form of a config value (JAX's): dataclasses
    and namedtuples flatten field by field, arrays become (dtype, shape,
    value hash), callables their qualname. An object's repr is scrubbed
    of addresses, so that two processes agree."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return repr(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__dc__": type(x).__name__,
                **{f.name: _canon(getattr(x, f.name))
                   for f in dataclasses.fields(x)}}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {"__nt__": type(x).__name__,
                **{k: _canon(v) for k, v in zip(x._fields, x)}}
    if isinstance(x, dict):
        return {"__d__": sorted(
            ([str(k), _canon(v)] for k, v in x.items()),
            key=lambda kv: kv[0])}
    if isinstance(x, (list, tuple, set, frozenset)):
        items = [_canon(v) for v in x]
        return sorted(map(json.dumps, items)) \
            if isinstance(x, (set, frozenset)) else items
    if hasattr(x, "shape") and hasattr(x, "dtype"):
        try:
            arr = np.asarray(x)
        except Exception:   # a meta or device tensor: shapes and dtypes
            return {"__s__": [_dtype_name(x.dtype), list(x.shape)]}
        return {"__a__": [str(arr.dtype), list(arr.shape),
                          hashlib.sha256(arr.tobytes()).hexdigest()[:16]]}
    if callable(x):
        return {"__f__": f"{getattr(x, '__module__', '?')}."
                         f"{getattr(x, '__qualname__', repr(x))}"}
    return {"__r__": _HEX.sub("0x", repr(x))}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _aval_sig(tree: Any) -> Dict[str, Any]:
    """Tree structure and per-leaf (dtype, shape): the carry's face of
    the key (wire width, instance count, which optional leaves exist)."""
    from .analysis.cost_model import flatten_paths
    leaves = flatten_paths(tree)
    return {"treedef": ";".join(p for p, _ in leaves),
            "leaves": [[_dtype_name(x.dtype), list(x.shape)]
                       for _, x in leaves]}


def store_key(sig: Dict[str, Any]) -> str:
    """Content address of one entry: sha256 of the canonical
    signature."""
    blob = json.dumps(_canon(sig), sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def toolchain() -> Dict[str, str]:
    """The torch and CUDA versions a library is built and loaded under."""
    return {"torch-version": torch.__version__,
            "cuda-version": torch.version.cuda or "none"}


def _device_sig(device=None) -> Tuple[str, str]:
    """``(platform, device kind)`` of ``device``: ``("cuda", "<name>
    sm_<major><minor>")`` for a card, ``("cpu", "cpu")`` otherwise. Reads
    a card's name only for a CUDA device (a CUDA context exists by
    then)."""
    dev = torch.device(device if device is not None else "cpu")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        return "cuda", f"{torch.cuda.get_device_name(idx)} sm_{major}{minor}"
    return dev.type, dev.type


def dispatch_libraries(platform: str) -> Tuple[str, ...]:
    """The kernel libraries a chunk dispatch on ``platform`` launches:
    the delivery kernel's on a card, none on the CPU (every wrapper
    takes its plain version there)."""
    from .kernels import delivery
    return (delivery.SOURCE,) if platform == "cuda" else ()


def _model_sig(model) -> Dict[str, Any]:
    return {"model": getattr(model, "name", type(model).__name__),
            "model-config": {k: v for k, v in vars(model).items()
                             if not k.startswith("_")}}


def pipelined_signature(model, sim, instance_ids, cap: Optional[int],
                        scan_k: int, length: int, carry, stats: bool,
                        device_sig: Tuple[str, str]) -> Dict[str, Any]:
    """Everything that determines the single-device chunk dispatch of
    ``pipeline.run_sim_pipelined``. ``instance_ids`` (host ints) are
    hashed by value, as JAX's are; ``cap`` None is a buffer sized per
    chunk length (the bench's), keyed as JAX keys it."""
    platform, kind = device_sig
    return {
        "store-version": STORE_VERSION, "kind": "pipelined",
        **_model_sig(model),
        "sim": sim, "instance-ids": np.asarray(instance_ids, np.int32),
        "cap": None if cap is None else int(cap), "scan-k": int(scan_k),
        "length": int(length),
        "stats": bool(stats), "carry": _aval_sig(carry),
        **toolchain(), "platform": platform, "device-kind": kind,
        "n-devices": 1, "src": source_digest(),
    }


def sharded_signature(model, sim, mesh_size: int, scan_k: int,
                      length: int, carry,
                      device_sig: Tuple[str, str]) -> Dict[str, Any]:
    """Everything that determines one shard's chunk dispatch of
    ``mesh.run_sim_sharded_chunked``: the mesh's shape joins the key,
    and ``carry`` is one shard's."""
    from .parallel.mesh import AXIS
    platform, kind = device_sig
    return {
        "store-version": STORE_VERSION, "kind": "sharded",
        **_model_sig(model),
        "sim": sim, "scan-k": int(scan_k), "length": int(length),
        "carry": _aval_sig(carry), "mesh": [[AXIS, int(mesh_size)]],
        **toolchain(), "platform": platform, "device-kind": kind,
        "n-devices": int(mesh_size), "src": source_digest(),
    }


def config_digest(sig: Dict[str, Any]) -> str:
    """The part of a signature the certificate's graph depends on
    besides the source: the model, the sim, the carry and the static
    chunk arguments (not the dispatch length: the certificate is always
    recorded at :data:`AOT_CHUNK_LEN` ticks). The audit compares an
    entry's certificate with a subject's only where these agree."""
    keep = ("kind", "model", "model-config", "sim", "cap", "scan-k",
            "stats", "carry", "mesh")
    return store_key({k: sig[k] for k in keep if k in sig})


def _graph_arg(a) -> Any:
    from .analysis.cost_model import Ref
    if isinstance(a, Ref):
        return f"%{a.vid}"
    if isinstance(a, (list, tuple)):
        return [_graph_arg(x) for x in a]
    if isinstance(a, (torch.dtype, torch.device, torch.memory_format,
                      torch.layout)):
        return str(a)
    if isinstance(a, bool) or a is None or isinstance(a, str):
        return a
    if isinstance(a, int):
        return int(a)
    if isinstance(a, float):
        return repr(a)
    return _HEX.sub("0x", repr(a))


def graph_digest(g) -> str:
    """The canonical fingerprint of a recorded dispatch: sha256 over the
    graph's inputs and constants (dtype, shape, a constant's value when
    known), each operator with its arguments (values by their index in
    the graph), outputs and phase, and the output list. Stable across
    recordings and processes, blind to object ids and addresses (pinned
    by ``tests/test_torch_aot.py``): the certificate ``lint --aot``
    re-derives and compares with every stored entry (EXE901)."""
    vals = []
    for v in g.values:
        if v.kind == "op":
            continue
        val = (hashlib.sha256(np.ascontiguousarray(v.value).tobytes())
               .hexdigest()[:16] if v.value is not None else None)
        vals.append([v.vid, v.kind, _dtype_name(v.dtype), list(v.shape),
                     val])
    nodes = [[str(n.op), _graph_arg(n.args),
              {k: _graph_arg(x) for k, x in sorted(n.kwargs.items())},
              list(n.outs), n.phase] for n in g.nodes]
    blob = json.dumps({"values": vals, "nodes": nodes,
                       "inputs": list(g.inputs),
                       "outputs": list(g.outputs)},
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def entry_label(model, sim, kind: str,
                mesh_size: Optional[int] = None) -> str:
    """The coarse identity of an entry — ``<workload>/n=<nodes>/
    <layout>/<kind>[/s=<mesh>]`` — with which the audit pairs store
    entries with its subjects even after the content hash drifted."""
    base = (f"{getattr(model, 'name', type(model).__name__)}"
            f"/n={sim.net.n_nodes}/{sim.layout}/{kind}")
    if mesh_size is not None:
        base += f"/s={mesh_size}"
    return base


def record_dispatch(kind: str, model, sim, *, cap: Optional[int] = 64,
                    scan_k: int = 8, stats: bool = True,
                    mesh_size: int = 1, length: int = AOT_CHUNK_LEN):
    """The aten graph of the chunk dispatch on ``meta`` tensors at
    ``length`` ticks (``cost_model.record_call``): the pipelined
    executor's ``pipeline.issue_chunk`` (``cap`` None: the buffer sized
    for ``length``), or shard 0's ``mesh.shard_chunk`` at ``mesh_size``
    shards."""
    from .analysis.cost_model import META, record_call
    from .runtime import init_carry, make_tick_fn
    if kind == "pipelined":
        from .pipeline import event_capacity, issue_chunk
        if cap is None:
            cap = event_capacity(sim, model, length)
        ids = torch.arange(sim.n_instances, dtype=torch.int32, device=META)
        carry = init_carry(model, sim, 0, META, ids)
        tick = make_tick_fn(model, sim, ids, META)
        return record_call(
            lambda c: issue_chunk(
                tick, c, 0, length, cap=cap, V=model.ev_vals,
                R=sim.record_instances, J=sim.journal_instances,
                instance_ids=ids, scan_k=scan_k, with_stats=stats,
                device=META), carry)
    from .parallel import mesh as mesh_mod
    return mesh_mod.record_shard_chunk(model, sim, mesh_size, length=length,
                                       scan_k=scan_k)


def _census(g) -> Dict[str, int]:
    from .analysis.shard_audit import census_of_graph
    c = census_of_graph(g)
    return {p: e["count"] for p, e in sorted(c["tick"].items())}


# --------------------------------------------------------------------
# the on-disk store
# --------------------------------------------------------------------


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(root: str, path: str, data, mode: str) -> None:
    os.makedirs(root, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            f.write(data)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _json(meta: Dict[str, Any]) -> str:
    return json.dumps(meta, indent=1, sort_keys=True) + "\n"


class AotStore:
    """The on-disk store: ``<key>.json`` per entry, ``lib/<libkey>.so``
    and ``lib/<libkey>.json`` per library."""

    def __init__(self, root: str):
        self.root = root
        self.lib_root = os.path.join(root, "lib")

    def _meta(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def lib_path(self, libkey: str) -> str:
        return os.path.join(self.lib_root, libkey + ".so")

    @staticmethod
    def _read_json(path: str) -> Optional[Dict[str, Any]]:
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def meta(self, key: str) -> Optional[Dict[str, Any]]:
        return self._read_json(self._meta(key))

    def lib_meta(self, libkey: str) -> Optional[Dict[str, Any]]:
        return self._read_json(os.path.join(self.lib_root,
                                            libkey + ".json"))

    def entries(self) -> Iterator[Tuple[str, Dict[str, Any]]]:
        """(key, meta) for every readable entry, key-sorted."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            meta = self.meta(name[:-5])
            if meta is not None:
                yield name[:-5], meta

    def library_bytes(self, libkey: str, sha: Optional[str] = None
                      ) -> Optional[bytes]:
        """A library's bytes when they hash to ``sha`` (default: its own
        sidecar's), else None."""
        want = sha
        if want is None:
            lm = self.lib_meta(libkey)
            want = None if lm is None else lm.get("sha256")
        try:
            with open(self.lib_path(libkey), "rb") as f:
                data = f.read()
        except OSError:
            return None
        return data if want is not None and _sha(data) == want else None

    def load_payload(self, key: str) -> Optional[Dict[str, bytes]]:
        """``{library name: bytes}`` of an entry, every library checked
        against the sha256 the entry recorded, or None (absent, missing
        or tampered). Not toolchain-gated: the audit reads entries it
        then refuses by name."""
        meta = self.meta(key)
        if meta is None:
            return None
        out = {}
        for lib in meta.get("libraries", []):
            data = self.library_bytes(lib.get("key", ""), lib.get("sha256"))
            if data is None:
                return None   # tampered or truncated: never load it
            out[lib["name"]] = data
        return out

    def check(self, key: str, device_sig: Tuple[str, str]
              ) -> Tuple[Optional[Dict[str, bytes]], Optional[str]]:
        """The runtime's load: ``(payload, None)`` on a hit, ``(None,
        None)`` when there is no entry, ``(None, reason)`` when the entry
        is refused by name — recorded under another toolchain or device
        kind (EXE904), or a library failing its sha256 (EXE901)."""
        meta = self.meta(key)
        if meta is None:
            return None, None
        where = f"store entry {key} ({meta.get('entry', '?')}) in {self.root}"
        platform, kind = device_sig
        running = dict(toolchain(), **{"platform": platform,
                                       "device-kind": kind})
        bad = [f"{k} {meta.get(k)!r} != {v!r}" for k, v in running.items()
               if meta.get(k) != v]
        if bad:
            return None, (f"EXE904 toolchain-incompatible-entry: {where} "
                          f"was recorded under another toolchain or device "
                          f"({'; '.join(bad)}): refused, treated as a miss")
        payload = self.load_payload(key)
        if payload is None:
            return None, (f"EXE901 executable-fingerprint-drift: {where}: "
                          f"a library is missing or no longer matches its "
                          f"recorded sha256 (tampered or truncated): "
                          f"refused, treated as a miss")
        return payload, None

    def load(self, key: str, device_sig: Tuple[str, str]
             ) -> Optional[Dict[str, bytes]]:
        """:meth:`check`'s payload, or None on any miss or refusal."""
        return self.check(key, device_sig)[0]

    def put(self, key: str, meta: Dict[str, Any]) -> None:
        """Write one entry's sidecar atomically."""
        _atomic_write(self.root, self._meta(key), _json(meta), "w")

    def put_library(self, libkey: str, data: bytes,
                    meta: Dict[str, Any]) -> str:
        """Write one library and its sidecar atomically; its sha256."""
        sha = _sha(data)
        _atomic_write(self.lib_root, self.lib_path(libkey), data, "wb")
        _atomic_write(self.lib_root,
                      os.path.join(self.lib_root, libkey + ".json"),
                      _json(dict(meta, sha256=sha)), "w")
        return sha


def lib_key(name: str, device_sig: Tuple[str, str]) -> str:
    """A library's store key: its source and flags, the toolchain and
    the device kind."""
    from .kernels import build
    blob = json.dumps({"source": build.source_hash(build.source(name)),
                       "flags": list(build.NVCC_FLAGS), **toolchain(),
                       "device-kind": device_sig[1]}, sort_keys=True)
    return f"{name}-{hashlib.sha256(blob.encode()).hexdigest()[:24]}"


def build_meta(sig: Dict[str, Any], cache_key: str, entry: str,
               digest: str, census: Dict[str, int],
               libraries: List[Dict[str, str]]) -> Dict[str, Any]:
    """The audit sidecar of one entry: what ``lint --aot`` checks
    without loading anything, and the certificate EXE901 compares."""
    return {
        "version": STORE_VERSION,
        "key": cache_key,
        "entry": entry,
        "kind": sig["kind"],
        "model": sig["model"],
        "fingerprint": {
            "graph-digest": digest,
            "src-digest": sig["src"],
            "config-digest": config_digest(sig),
            "carry-layout": getattr(sig.get("sim"), "layout", None),
            "chunk-length": AOT_CHUNK_LEN,
            "dispatch-length": sig["length"],
            "mesh": sig.get("mesh"),
        },
        **toolchain(),
        "platform": sig["platform"],
        "device-kind": sig["device-kind"],
        "collectives": census,
        "libraries": libraries,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def ensure_libraries(store: AotStore, names: Sequence[str],
                     device_sig: Tuple[str, str],
                     record: Optional[Dict[str, Any]] = None
                     ) -> List[Dict[str, str]]:
    """Every named library in the store: one whose bytes check is
    reused, one the store lacks (or whose bytes fail) is built with a
    real ``nvcc`` into the store. The entry's library list."""
    from .kernels import build
    out = []
    for name in names:
        lk = lib_key(name, device_sig)
        data = store.library_bytes(lk)
        if data is None:
            os.makedirs(store.lib_root, exist_ok=True)
            tmp = os.path.join(store.lib_root,
                               f".{lk}.{os.getpid()}.build.so")
            t0 = time.monotonic()
            try:
                build.build_to(name, tmp)
                with open(tmp, "rb") as f:
                    data = f.read()
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            dt = time.monotonic() - t0
            store.put_library(lk, data, {
                "name": name, "source": build.source_hash(
                    build.source(name)),
                "flags": list(build.NVCC_FLAGS), **toolchain(),
                "device-kind": device_sig[1], "nvcc-s": round(dt, 3),
                "created": time.strftime("%Y-%m-%dT%H:%M:%S")})
            if record is not None:
                record["nvcc"] += 1
                record["nvcc-s"] += dt
        out.append({"name": name, "key": lk, "sha256": _sha(data)})
    return out


def install_payload(store: AotStore, meta: Dict[str, Any],
                    payload: Dict[str, bytes],
                    record: Optional[Dict[str, Any]] = None) -> None:
    """Load each library of a checked payload: its checked bytes are
    written to a private file, which is ``dlopen``\\ ed and unlinked. A
    library this process already loaded is kept (a process keeps its
    first)."""
    from .kernels import build
    keys = {lib["name"]: lib["key"] for lib in meta.get("libraries", [])}
    for name, data in payload.items():
        origin = f"store {store.lib_path(keys[name])}"
        if build.is_loaded(name):
            if record is not None:
                record["libraries"][name] = "already loaded by this process"
            continue
        os.makedirs(build.BUILD_DIR, exist_ok=True)
        fd, path = tempfile.mkstemp(dir=build.BUILD_DIR,
                                    prefix=f".{keys[name]}-", suffix=".so")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            build.install(name, path, origin)
        finally:
            os.unlink(path)
        if record is not None:
            record["libraries"][name] = origin


# --------------------------------------------------------------------
# dispatch wrappers (the production integration points)
# --------------------------------------------------------------------


def _fresh_record(store_dir: str) -> Dict[str, Any]:
    return {"store": store_dir, "hit": False, "load-s": 0.0,
            "fingerprint": None, "lengths": {}, "refused": [],
            "nvcc": 0, "nvcc-s": 0.0, "record-s": 0.0, "libraries": {}}


def finalize_record(rec: Optional[Dict[str, Any]]
                    ) -> Optional[Dict[str, Any]]:
    if rec is not None:
        for k in ("load-s", "nvcc-s", "record-s"):
            rec[k] = round(rec[k], 4)
    return rec


def _resolve(store: AotStore, record: Dict[str, Any], sig, label: str,
             length: int, recorder) -> None:
    """One dispatch length against the store: a hit loads the entry's
    libraries; a refusal is named in ``record["refused"]`` (and on
    standard error) and treated as a miss; a miss records the
    certificate (``recorder()``, cached across lengths), builds what the
    store lacks and writes the entry, then loads it."""
    key = store_key(sig)
    if record["fingerprint"] is None:
        record["fingerprint"] = key
    device_sig = (sig["platform"], sig["device-kind"])
    t0 = time.monotonic()
    payload, refusal = store.check(key, device_sig)
    if refusal is not None:
        record["refused"].append(refusal)
        print(f"aot store: {refusal}", file=sys.stderr)
    if payload is not None:
        install_payload(store, store.meta(key), payload, record)
        record["load-s"] += time.monotonic() - t0
        record["hit"] = True
        record["lengths"][str(length)] = "hit"
        return
    record["lengths"][str(length)] = "miss"
    t_r = time.monotonic()
    digest, census = recorder()
    record["record-s"] += time.monotonic() - t_r
    libraries = ensure_libraries(store, dispatch_libraries(sig["platform"]),
                                 device_sig, record)
    meta = build_meta(sig, key, label, digest, census, libraries)
    store.put(key, meta)
    payload = store.load_payload(key)
    if payload is None:
        raise RuntimeError(f"store entry {key} failed its own check")
    install_payload(store, meta, payload, record)
    record["lengths"][str(length)] = "populated"


def _certificate(kind: str, model, sim, **kw):
    """A recorder of ``(graph digest, census)``, run once."""
    memo: List[Tuple[str, Dict[str, int]]] = []

    def run():
        if not memo:
            g = record_dispatch(kind, model, sim, **kw)
            memo.append((graph_digest(g), _census(g)))
        return memo[0]
    return run


def _guarded(record: Dict[str, Any], length: int, fn) -> None:
    try:
        fn()
    except Exception as e:
        record["lengths"][str(length)] = "error"
        record["error"] = repr(e)[:200]


def wrap_pipelined(issue, *, model, sim, instance_ids,
                   cap: Optional[int], scan_k: int, stats: bool, device,
                   store_dir: Optional[str]):
    """Wrap the chunked executor's ``issue(carry, t0, length)`` with the
    store: the first chunk of each length resolves that length's entry
    before it is issued (a hit loads the libraries, a miss populates
    the entry), then every chunk is issued as without the store.
    ``cap`` None keys a dispatch whose buffer is sized per length. A
    store failure is recorded under ``error`` and the run goes on.
    Returns ``(wrapped, record)``; ``(None, None)`` when the store is
    disabled."""
    if store_dir is None:
        return None, None
    store = AotStore(store_dir)
    record = _fresh_record(store_dir)
    done = set()
    ids = np.asarray(instance_ids.cpu() if isinstance(
        instance_ids, torch.Tensor) else instance_ids, np.int32)
    cert = _certificate("pipelined", model, sim, cap=cap, scan_k=scan_k,
                        stats=stats)

    def wrapped(carry, t0, length):
        if length not in done:
            done.add(length)

            def resolve():
                sig = pipelined_signature(model, sim, ids, cap, scan_k,
                                          length, carry, stats,
                                          _device_sig(device))
                _resolve(store, record, sig,
                         entry_label(model, sim, "pipelined"), length, cert)
            _guarded(record, length, resolve)
        return issue(carry, t0, length)

    return wrapped, record


def wrap_sharded(issue_all, *, model, sim, mesh, carry, scan_k: int,
                 store_dir: Optional[str]):
    """The sharded twin of :func:`wrap_pipelined`: wraps
    ``issue_all(t0, length)`` of ``mesh.run_sim_sharded_chunked``; the
    key holds one shard's carry (``carry``) and the mesh's shape, and
    the libraries are those of the devices of this process's shards.
    Returns ``(wrapped, record)`` or ``(None, None)`` when disabled."""
    if store_dir is None:
        return None, None
    store = AotStore(store_dir)
    record = _fresh_record(store_dir)
    done = set()
    size = int(mesh.size)
    local = [mesh.devices[s] for s in mesh.local_shards]
    dev = next((d for d in local if d.type == "cuda"), local[0])
    cert = _certificate("sharded", model, sim, scan_k=scan_k,
                        mesh_size=size)

    def wrapped(t0, length):
        if length not in done:
            done.add(length)

            def resolve():
                sig = sharded_signature(model, sim, size, scan_k, length,
                                        carry, _device_sig(dev))
                _resolve(store, record, sig,
                         entry_label(model, sim, "sharded", mesh_size=size),
                         length, cert)
            _guarded(record, length, resolve)
        return issue_all(t0, length)

    return wrapped, record


# --------------------------------------------------------------------
# provenance (heartbeat / campaign resume / triage) and prewarm
# --------------------------------------------------------------------


def _meta_carry(model, sim):
    from .analysis.cost_model import META
    from .runtime import init_carry
    with torch.no_grad():
        return init_carry(model, sim, 0, META)


def pipelined_fingerprint(model, sim, chunk: int = 100,
                          event_cap: Optional[int] = None,
                          scan_k: int = 8, instance_ids=None,
                          stats: bool = True, device=None,
                          device_sig: Optional[Tuple[str, str]] = None
                          ) -> str:
    """The store key of a run's first chunk dispatch, computed as
    :func:`wrap_pipelined` computes it — from shapes alone (the carry on
    ``meta`` tensors): nothing is recorded and nothing built. The
    heartbeat's run-start record carries it; ``campaign resume`` and
    ``triage`` recompute it for the recorded device (``device_sig``) and
    refuse a drift by name (EXE901)."""
    from .pipeline import event_capacity, plan_chunks
    plans = plan_chunks(sim.n_ticks, chunk)
    cap = (event_capacity(sim, model, plans[0][1])
           if not event_cap else int(event_cap))
    ids = (np.arange(sim.n_instances, dtype=np.int32)
           if instance_ids is None else instance_ids)
    sig = pipelined_signature(model, sim, ids, cap, scan_k, plans[0][1],
                              _meta_carry(model, sim), stats,
                              device_sig or _device_sig(device))
    return store_key(sig)


def prewarm_pipelined(model, sim, store_dir: str, chunk: int = 100,
                      event_cap: Optional[int] = None, scan_k: int = 8,
                      stats: bool = True, device=None) -> Dict[str, str]:
    """Populate the entry of every chunk length a ``run_sim_pipelined(
    model, sim, chunk=chunk)`` run dispatches on ``device``, without
    running the simulation (shapes only; the library built once). Returns
    ``{length: "hit" | "populated" | "error: ..."}``; a stored length is
    left untouched."""
    from .pipeline import event_capacity, plan_chunks
    plans = plan_chunks(sim.n_ticks, chunk)
    cap = (event_capacity(sim, model, plans[0][1])
           if not event_cap else int(event_cap))
    store = AotStore(store_dir)
    ids = np.arange(sim.n_instances, dtype=np.int32)
    carry = _meta_carry(model, sim)
    dsig = _device_sig(device)
    cert = _certificate("pipelined", model, sim, cap=cap, scan_k=scan_k,
                        stats=stats)
    out: Dict[str, str] = {}
    for length in sorted({ln for _, ln in plans}):
        try:
            sig = pipelined_signature(model, sim, ids, cap, scan_k, length,
                                      carry, stats, dsig)
            key = store_key(sig)
            if store.meta(key) is not None:
                out[str(length)] = "hit"
                continue
            digest, census = cert()
            libraries = ensure_libraries(store,
                                         dispatch_libraries(dsig[0]), dsig)
            store.put(key, build_meta(sig, key,
                                      entry_label(model, sim, "pipelined"),
                                      digest, census, libraries))
            out[str(length)] = "populated"
        except Exception as e:
            out[str(length)] = f"error: {repr(e)[:160]}"
    return out
