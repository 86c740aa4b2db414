"""Checkpoint and resume: durable snapshots of a live run, continued bit
for bit — the port's copy of the reference's
``testground_tpu/sim/checkpoint.py``, reading and writing the reference's
archive byte-compatibly, so a snapshot taken by either package resumes in
the other and a snapshot taken on the CPU resumes on the card.

A snapshot is one atomic ``checkpoints/ckpt-<tick>.npz`` under the run's
directory:

- the carry, leaf for leaf under ``leaf_NNNNN`` in the reference's
  ``jax.tree_util.tree_leaves`` order (``_LEAF_ORDER``, written out here
  from the reference's ``SimCarry`` declaration: dataclass fields in
  order, dict keys sorted, absent planes skipped), with the reference's
  shapes and dtypes:

  - the calendar planes follow the run's ``transport`` as the reference
    lays them out: flat ``[L·N·SLOTS]`` under ``xla`` (and ``auto``),
    ``[L, N·SLOTS]`` under ``pallas`` and on a mesh. On the card the port
    runs K1/K2 under every knob, so the layout follows the knob, not
    what ran;
  - flow totals as the reference's ``(hi, lo)`` int32 limbs with the
    30-bit spill, back to int64 on restore;
  - the per-instance keys and the link key as uint32 key data with
    ``kind: "prng"`` and the reference's key impl string;
- the host accumulators of the latency histogram and the traffic matrix
  under ``aux_lat_hist`` / ``aux_net_matrix``;
- the manifest JSON under ``__manifest__`` (``FORMAT_VERSION``, the tick,
  the run identity and its hashes, the leaves' metas, the host-side aux
  state), with ``"torch": torch.__version__`` where the reference writes
  its jax version (neither package's loader reads that key).

The snapshot reads the live carry at a chunk boundary, where the loop has
already waited on the chunk's last tick, and before the next chunk is
issued (the next chunk updates the carry in place): every leaf is copied
with ``non_blocking`` into pinned host buffers, allocated at the first
snapshot and reused, then the host waits once per device. Nothing is
cloned on the device. With ``checkpoint_chunks = 0`` no code of this
module runs. Restore validates every leaf's shape and dtype against the
program's carry built on the meta device (or a carry the caller already
holds) before a byte reaches the device, with the reference's messages,
and builds the carry through ``carry_io.carry_from_numpy`` (a mesh's
calendar through its shard split).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import random
import time
import zipfile

import numpy as np
import torch

__all__ = [
    "CHECKPOINT_DIR",
    "CheckpointError",
    "ResumeState",
    "RunCheckpointer",
    "identity_hash",
    "leaf_paths",
    "list_snapshots",
    "load_latest",
    "load_snapshot",
    "prepare_resume",
    "restore_carry",
    "run_identity",
    "save_snapshot",
    "snapshot_carry",
]

CHECKPOINT_DIR = "checkpoints"
_PREFIX = "ckpt-"
_SUFFIX = ".npz"
_TICK_WIDTH = 12  # zero-padded so lexical order == tick order

# load retry budget: a snapshot being fetched or copied for a migration can
# hit transient I/O that reads as corruption on the first try
_RETRY_ATTEMPTS = 3
_RETRY_BASE_SECS = 0.25
_RETRY_JITTER_SECS = 0.1

FORMAT_VERSION = 1

_MANIFEST_KEY = "__manifest__"
_LEAF_FMT = "leaf_{:05d}"
_AUX_LAT_KEY = "aux_lat_hist"
_AUX_NM_KEY = "aux_net_matrix"

# ``str(jax.random.key_impl(key))`` of the reference's keys under jax's
# default PRNG (recorded from the reference by tests/test_torch_checkpoint.py)
KEY_IMPL = "threefry2x32"

# The reference's carry leaves in ``tree_leaves`` order, by the dotted
# paths of the exchange format (``sim/carry_io.py``). ``states.*`` expands
# to each group's keys, sorted; ``cal.payload.*`` to each payload word.
# Paths whose plane is off are skipped.
_LEAF_ORDER = (
    "states.*", "status", "finished_at",
    "cal.payload.*", "cal.src", "cal.valid", "cal.etick",
    "link.egress", "link.filters", "link.region_of", "link.backlog", "link.rules",
    "sync.counts", "sync.last_seq", "sync.stream", "sync.stream_len",
    "sync.cursors", "sync.dropped",
    "rejected", "keys", "net_key", "t", "clamped", "bw_dropped",
    "bw_rate_changed", "collisions", "collision_where",
    "msgs_delivered", "msgs_sent", "msgs_enqueued", "msgs_dropped",
    "msgs_rejected", "cal_depth", "faults_crashed", "faults_restarted",
    "fault_dropped", "lat_hist", "live_counts", "net_mat", "net_bw_hiwater",
)
_PRNG = ("keys", "net_key")
_LIMBS = ("msgs_delivered", "msgs_sent", "msgs_enqueued", "msgs_dropped",
          "msgs_rejected", "fault_dropped")
_LIMB_BITS = 30
_LIMB_MASK = (1 << _LIMB_BITS) - 1


class CheckpointError(RuntimeError):
    """A snapshot could not be written, read, validated or restored: the
    typed refusal — a damaged or mismatched snapshot never seeds a run."""


# --------------------------------------------------------------- identity


def run_identity(job, cfg, *, telemetry: bool, transport: str, fault_specs: dict,
                 trace_specs: dict, hosts, bucket=None, netmatrix: bool = False) -> dict:
    """Everything that shapes the program or the tick stream
    (``checkpoint.py:114-175``), so that a snapshot refuses to seed a run
    built another way. ``max_ticks`` is absent: it is a budget. ``sources``
    digests each group's plan sources; each package digests its own plan
    copy, so it is the one key on which the two packages' identities of
    one composition differ. ``bucket`` (the padded per-group counts, keyed
    only when the run is bucketed) shapes every carry leaf, so a snapshot
    from one bucket refuses to seed another; a mesh's internal padding
    keys nothing, its snapshots having the exact shapes."""
    from ..builders.sim_plan import _source_digest

    sources = {}
    for g in job.groups:
        try:
            sources[g.id] = _source_digest(g.artifact_path)
        except OSError:
            sources[g.id] = ""
    return {
        "plan": job.test_plan,
        "case": job.test_case,
        "groups": [
            {"id": g.id, "instances": g.instances, "parameters": dict(g.parameters)}
            for g in job.groups
        ],
        "sources": sources,
        "tick_ms": cfg.tick_ms,
        "chunk": cfg.chunk,
        "seed": cfg.seed,
        "validate": bool(getattr(cfg, "validate", False)),
        "telemetry": bool(telemetry),
        "transport": str(transport),
        "faults": fault_specs,
        "trace": trace_specs,
        "hosts": list(hosts),
        **({"bucket": list(bucket)} if bucket else {}),
        **({"netmatrix": True} if netmatrix else {}),
    }


def identity_hash(identity: dict, drop: tuple = ()) -> str:
    """sha256 of the sorted-key JSON, truncated (the reference's)."""
    d = {k: v for k, v in identity.items() if k not in drop}
    return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:32]


# ------------------------------------------------------------ carry <-> np


def leaf_paths(carry) -> list[str]:
    """The carry's dotted leaf paths in the reference's leaf order."""
    out = []
    for entry in _LEAF_ORDER:
        if entry == "states.*":
            for gi, s in enumerate(carry.states):
                out.extend(f"states.{gi}.{k}" for k in sorted(s))
        elif entry == "cal.payload.*":
            out.extend(f"cal.payload.{w}" for w in range(len(carry.cal.payload)))
        elif _source(carry, entry) is not None:
            out.append(entry)
    return out


def _source(carry, path: str):
    """The tensor (a tuple of shard tensors for a meshed calendar plane, a
    host tuple for the link key) at ``path``, or None."""
    head, _, rest = path.partition(".")
    if head == "states":
        gi, _, k = rest.partition(".")
        return carry.states[int(gi)][k]
    if head == "cal" and rest.startswith("payload."):
        return carry.cal.payload[int(rest.split(".")[1])]
    if head in ("cal", "link", "sync"):
        return getattr(getattr(carry, head), rest, None)
    return getattr(carry, head, None)


def _flat_layout(transport: str, carry) -> bool:
    """The reference stores calendar planes flat unless it runs pallas or
    a mesh (``engine.py:893``)."""
    return carry.cal.mesh is None and str(transport).lower() != "pallas"


def _np_dtype(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _expected(carry, path: str, flat: bool) -> dict:
    """The reference's meta (kind, shape, dtype) of ``path`` for a carry of
    these shapes — read off the shapes, never the data."""
    src = _source(carry, path)
    if path in _PRNG:
        shape = [len(src)] if path == "net_key" else [int(src.shape[0]), 2]
        return {"kind": "prng", "impl": KEY_IMPL, "shape": shape, "dtype": "uint32"}
    if path in _LIMBS:
        return {"kind": "array", "shape": [2], "dtype": "int32"}
    if path.startswith("cal."):
        parts = src if isinstance(src, tuple) else (src.unsqueeze(0),)
        horizon = int(parts[0].shape[1])
        width = sum(int(p.shape[0]) * int(p.shape[2]) for p in parts)
        shape = [horizon * width] if flat else [horizon, width]
        return {"kind": "array", "shape": shape, "dtype": _np_dtype(parts[0].dtype)}
    return {"kind": "array", "shape": list(src.shape), "dtype": _np_dtype(src.dtype)}


class _HostStage:
    """Pinned host buffers for the carry's device leaves, allocated at the
    first fetch and reused by every later one. A CPU leaf is cloned (the
    next chunk updates the live carry in place)."""

    def __init__(self):
        self._bufs: dict = {}

    def fetch(self, carry, paths) -> dict:
        """``{path: host tensor(s)}``: every copy queued, then one wait per
        device."""
        out: dict = {}
        devices = {}
        for path in paths:
            if path == "net_key":
                continue
            src = _source(carry, path)
            parts = src if isinstance(src, tuple) else (src,)
            host = []
            for i, t in enumerate(parts):
                if t.device.type != "cuda":
                    host.append(t.detach().clone())
                    continue
                key = (path, i)
                buf = self._bufs.get(key)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    self._bufs[key] = buf
                with torch.cuda.device(t.device):
                    buf.copy_(t, non_blocking=True)
                devices[t.device] = None
                host.append(buf)
            out[path] = tuple(host) if isinstance(src, tuple) else host[0]
        for dev in devices:
            with torch.cuda.device(dev):
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                ev.synchronize()
        return out


def snapshot_carry(carry, transport: str = "xla", stage: _HostStage | None = None,
                   export=None) -> tuple[list, list]:
    """The live carry as the reference's ``(leaves, metas)``
    (``checkpoint.py:202-238``): numpy leaves in the reference's order,
    shapes and dtypes, laid out for ``transport``. ``stage`` keeps pinned
    buffers across snapshots; the leaves then view them until the next
    fetch. ``export`` (``SimProgram.lane_export()``) cuts a mesh
    padding's dead lanes out. The device→host read is the plane's only
    cost."""
    from .net import from_shards

    paths = leaf_paths(carry)
    flat = _flat_layout(transport, carry)
    host = (stage or _HostStage()).fetch(carry, paths)
    leaves, metas = [], []
    for path in paths:
        meta = _expected(carry, path, flat)
        if path == "net_key":
            data = np.asarray(carry.net_key, dtype=np.uint32)
        elif path == "keys":
            data = host[path].numpy().astype(np.uint32)
        elif path in _LIMBS:
            v = int(host[path].numpy())
            data = np.array([v >> _LIMB_BITS, v & _LIMB_MASK], dtype=np.int32)
        elif path.startswith("cal.") and isinstance(host[path], tuple):
            data = from_shards(list(host[path]), carry.cal.slots, "cpu").numpy()
        else:
            data = host[path].numpy()
        if path.startswith("cal.") and flat:
            data = data.reshape(-1)
        if export is not None:
            data = export.take(path, data)
            meta = dict(meta, shape=list(data.shape))
        leaves.append(data)
        metas.append(meta)
    return leaves, metas


def restore_carry(prog, seed: int, manifest: dict, leaves: list, *,
                  transport: str | None = None, template=None):
    """The carry on ``prog.device`` from snapshot leaves
    (``checkpoint.py:241-326``): every leaf is validated kind, shape and
    dtype against the program's own carry — ``template`` (a carry of the
    program the caller already holds) or the program's carry on the meta
    device — in the layout of ``transport`` (the restoring run's knob;
    the manifest's when None), with the reference's messages, before
    anything is copied to the device. ``seed`` is the reference's
    signature: a snapshot holds every key. A mesh-padded program's
    snapshot has the caller's layout (``SimProgram.lane_export``): its
    dead lanes come back from ``template``, else from a fresh carry."""
    from .carry_io import carry_from_numpy

    export = prog.lane_export()
    if template is not None:
        ref = template
    else:
        ref = prog.init_carry(seed) if export is not None else prog.meta_carry()
    if transport is None:
        transport = manifest.get("transport") or (
            manifest.get("identity") or {}).get("transport") or "xla"
    flat = _flat_layout(transport, ref)
    paths = leaf_paths(ref)
    metas = manifest.get("leaves") or []
    if len(leaves) != len(paths) or len(metas) != len(paths):
        raise CheckpointError(
            f"snapshot holds {len(leaves)} carry leaves but this program's "
            f"carry has {len(paths)} — the snapshot was taken under a "
            "different program shape (plan edit? different telemetry/"
            "transport gates?); refusing to resume"
        )
    arrays = {}
    for i, (data, meta, path) in enumerate(zip(leaves, metas, paths)):
        want = _expected(ref, path, flat)
        if export is not None:
            want["shape"] = export.shape(path, want["shape"])
        data = np.asarray(data)
        kind = meta.get("kind", "array")
        if kind == "prng":
            if want["kind"] != "prng":
                raise CheckpointError(
                    f"snapshot leaf {i} is a PRNG key but the program "
                    "expects a plain array there — program shape drift; "
                    "refusing to resume"
                )
            if meta.get("impl") and meta["impl"] != KEY_IMPL:
                raise CheckpointError(
                    f"snapshot PRNG leaf {i} was saved under key impl "
                    f"{meta.get('impl')!r} but this build resolves "
                    f"{KEY_IMPL!r} — resuming would change the random "
                    "stream; refusing"
                )
            if list(data.shape) != want["shape"] or str(data.dtype) != want["dtype"]:
                raise CheckpointError(
                    f"snapshot PRNG leaf {i} restores as "
                    f"{data.dtype}{list(data.shape)} but the program "
                    f"expects {want['dtype']}{want['shape']}; refusing to "
                    "resume"
                )
        else:
            if want["kind"] == "prng":
                raise CheckpointError(
                    f"snapshot leaf {i} is a plain array but the program "
                    "expects a PRNG key there — program shape drift; "
                    "refusing to resume"
                )
            if list(data.shape) != want["shape"] or str(data.dtype) != want["dtype"]:
                raise CheckpointError(
                    f"snapshot leaf {i} is {data.dtype}{list(data.shape)} but "
                    f"the program expects {want['dtype']}{want['shape']} — the "
                    "snapshot was taken under a different composition; "
                    "refusing to resume"
                )
        arrays[path] = data
    if export is not None:
        fresh, _ = snapshot_carry(ref, transport)
        for path, tmpl in zip(paths, fresh):
            arrays[path] = export.put(path, tmpl, arrays[path])
    del ref
    return carry_from_numpy(arrays, prog)


# ------------------------------------------------------------ file format


def _snapshot_name(tick: int) -> str:
    return f"{_PREFIX}{int(tick):0{_TICK_WIDTH}d}{_SUFFIX}"


def _tick_of(name: str) -> int | None:
    if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
        return None
    digits = name[len(_PREFIX): -len(_SUFFIX)]
    return int(digits) if digits.isdigit() else None


def list_snapshots(run_dir: str) -> list[tuple[int, str]]:
    """``[(tick, path)]`` ascending by tick; other names and in-flight
    temp files are ignored."""
    d = os.path.join(run_dir, CHECKPOINT_DIR)
    try:
        names = os.listdir(d)
    except OSError:
        return []
    out = []
    for name in names:
        tick = _tick_of(name)
        if tick is not None:
            out.append((tick, os.path.join(d, name)))
    out.sort()
    return out


def save_snapshot(run_dir: str, manifest: dict, leaves: list, lat_hist=None,
                  net_matrix=None) -> tuple[str, int, float]:
    """Write one snapshot atomically (a temp file, fsync, ``os.replace``);
    returns ``(path, bytes, write_ms)`` (``checkpoint.py:360-402``)."""
    t0 = time.perf_counter()
    d = os.path.join(run_dir, CHECKPOINT_DIR)
    try:
        os.makedirs(d, exist_ok=True)
        arrays = {_LEAF_FMT.format(i): leaf for i, leaf in enumerate(leaves)}
        if lat_hist is not None:
            arrays[_AUX_LAT_KEY] = np.asarray(lat_hist)
        if net_matrix is not None:
            arrays[_AUX_NM_KEY] = np.asarray(net_matrix)
        arrays[_MANIFEST_KEY] = np.frombuffer(json.dumps(manifest).encode(),
                                              dtype=np.uint8)
        final = os.path.join(d, _snapshot_name(manifest["tick"]))
        tmp = final + f".tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        size = os.path.getsize(final)
    except OSError as e:
        raise CheckpointError(f"snapshot write failed: {e}") from e
    return final, size, (time.perf_counter() - t0) * 1000.0


def prune_snapshots(run_dir: str, keep: int) -> int:
    """Delete all but the newest ``keep`` snapshots; best-effort."""
    if keep <= 0:
        return 0
    removed = 0
    for _, path in list_snapshots(run_dir)[:-keep]:
        try:
            os.unlink(path)
            removed += 1
        except OSError:
            pass
    return removed


def load_snapshot(path: str) -> tuple[dict, list]:
    """One snapshot → ``(manifest, carry leaves)``; every defect raises
    :class:`CheckpointError` naming the file (``checkpoint.py:422-489``)."""
    try:
        # members stream out of the zip on access: the archive is never
        # held whole beside its leaves
        with np.load(path, allow_pickle=False) as z:
            names = set(z.files)
            if _MANIFEST_KEY not in names:
                raise CheckpointError(
                    f"snapshot {path} has no embedded manifest — not a "
                    "checkpoint archive (or one written by an "
                    "incompatible version); refusing to resume"
                )
            try:
                manifest = json.loads(bytes(z[_MANIFEST_KEY]).decode())
            except (ValueError, UnicodeDecodeError) as e:
                raise CheckpointError(
                    f"snapshot {path} manifest is not valid JSON ({e}) — "
                    "corrupt archive; refusing to resume"
                ) from e
            if manifest.get("version") != FORMAT_VERSION:
                raise CheckpointError(
                    f"snapshot {path} is format version "
                    f"{manifest.get('version')!r}, this build reads "
                    f"{FORMAT_VERSION} — refusing to reinterpret"
                )
            n = len(manifest.get("leaves") or [])
            leaves = []
            for i in range(n):
                key = _LEAF_FMT.format(i)
                if key not in names:
                    raise CheckpointError(
                        f"snapshot {path} is missing carry leaf {i} of "
                        f"{n} — truncated or corrupt archive; refusing "
                        "to resume"
                    )
                leaves.append(z[key])
            if manifest.get("aux", {}).get("lat_hist"):
                if _AUX_LAT_KEY not in names:
                    raise CheckpointError(
                        f"snapshot {path} manifest promises a latency "
                        "accumulator but the archive has none — corrupt; "
                        "refusing to resume"
                    )
                manifest["_lat_hist"] = z[_AUX_LAT_KEY]
            if manifest.get("aux", {}).get("net_matrix"):
                if _AUX_NM_KEY not in names:
                    raise CheckpointError(
                        f"snapshot {path} manifest promises a traffic-"
                        "matrix accumulator but the archive has none — "
                        "corrupt; refusing to resume"
                    )
                manifest["_net_matrix"] = z[_AUX_NM_KEY]
    except CheckpointError:
        raise
    except (zipfile.BadZipFile, ValueError, KeyError, OSError, EOFError) as e:
        raise CheckpointError(
            f"snapshot {path} is corrupt or truncated ({type(e).__name__}: "
            f"{e}); refusing to resume"
        ) from e
    return manifest, leaves


def _load_snapshot_retrying(path: str) -> tuple[dict, list]:
    """:func:`load_snapshot` under the bounded retry budget: exponential
    backoff with jitter between attempts."""
    last: CheckpointError | None = None
    for attempt in range(1, _RETRY_ATTEMPTS + 1):
        try:
            return load_snapshot(path)
        except CheckpointError as e:
            last = e
            if attempt < _RETRY_ATTEMPTS:
                time.sleep(_RETRY_BASE_SECS * 2 ** (attempt - 1)
                           + random.uniform(0, _RETRY_JITTER_SECS))
    raise last  # type: ignore[misc]  # the loop always sets it


def load_latest(run_dir: str) -> tuple[dict, list, str]:
    """The newest loadable snapshot → ``(manifest, leaves, path)``. A newer
    one that still fails after its retries is skipped loudly: the returned
    manifest carries ``_fallback`` (the skipped files and the first
    error). No snapshot, or none loadable, refuses
    (``checkpoint.py:508-549``)."""
    snaps = list_snapshots(run_dir)
    if not snaps:
        raise CheckpointError(
            f"no snapshots under {os.path.join(run_dir, CHECKPOINT_DIR)} — "
            "was the run checkpointed (--run-cfg checkpoint_chunks=K)?"
        )
    skipped: list[str] = []
    first_error = ""
    for _, path in reversed(snaps):
        try:
            manifest, leaves = _load_snapshot_retrying(path)
        except CheckpointError as e:
            if not skipped:
                first_error = str(e)
            skipped.append(os.path.basename(path))
            continue
        if skipped:
            manifest["_fallback"] = {"skipped": list(skipped),
                                     "error": first_error[:300]}
        return manifest, leaves, path
    raise CheckpointError(
        "every retained snapshot under "
        f"{os.path.join(run_dir, CHECKPOINT_DIR)} is corrupt or "
        f"unreadable ({', '.join(skipped)}) — refusing to resume; "
        f"newest failed with: {first_error}"
    )


def validate_manifest(manifest: dict, identity: dict) -> None:
    """Refuse a snapshot taken under another run identity, naming the
    fields that differ."""
    want = identity_hash(identity)
    got = manifest.get("build_key")
    if got == want:
        return
    theirs = manifest.get("identity") or {}
    diffs = [k for k in sorted(set(identity) | set(theirs))
             if identity.get(k) != theirs.get(k)]
    raise CheckpointError(
        "snapshot was taken under a different run identity — "
        f"mismatched field(s): {diffs or ['<unrecorded identity>']} "
        f"(snapshot build_key {got!r}, this run {want!r}); a resumed run "
        "must rebuild the exact program that wrote the snapshot"
    )


# ---------------------------------------------------------------- resume


@dataclasses.dataclass
class ResumeState:
    """What the executor needs to continue a run from a snapshot."""

    manifest: dict
    leaves: list
    path: str  # the snapshot file
    source_run_dir: str

    @property
    def tick(self) -> int:
        return int(self.manifest.get("tick", 0))

    @property
    def lat_hist(self):
        h = self.manifest.get("_lat_hist")
        return None if h is None else np.asarray(h, dtype=np.int64)

    @property
    def net_matrix(self):
        m = self.manifest.get("_net_matrix")
        return None if m is None else np.asarray(m, dtype=np.int64)

    @property
    def aux(self) -> dict:
        return self.manifest.get("aux") or {}


def _sync_stream_files(source_run_dir: str, dest_run_dir: str, offsets: dict) -> None:
    """Make the destination's stream files hold exactly the rows written up
    to the snapshot's tick: truncate in place (same dir), or copy each
    file's prefix (another run's dir). The offsets were taken after the
    writers' per-chunk flush, so they fall on row boundaries."""
    for name, offset in (offsets or {}).items():
        # names come from the manifest: plain basenames only
        if name != os.path.basename(name) or not isinstance(offset, int):
            raise CheckpointError(
                f"snapshot stream-offset entry {name!r} is not a plain "
                "file name — refusing to resume from a doctored manifest"
            )
        src = os.path.join(source_run_dir, name)
        dst = os.path.join(dest_run_dir, name)
        try:
            if os.path.abspath(src) == os.path.abspath(dst):
                if os.path.exists(src):
                    with open(src, "r+b") as f:
                        f.truncate(offset)
                continue
            if not os.path.exists(src):
                continue
            with open(src, "rb") as fin, open(dst, "wb") as fout:
                remaining = int(offset)
                while remaining > 0:
                    buf = fin.read(min(remaining, 4 << 20))
                    if not buf:
                        break
                    fout.write(buf)
                    remaining -= len(buf)
        except OSError as e:
            raise CheckpointError(
                f"could not prepare stream file {name} for resume: {e}"
            ) from e


def prepare_resume(source_run_dir: str, dest_run_dir: str | None,
                   identity: dict) -> ResumeState:
    """Load and validate the newest snapshot of ``source_run_dir`` and
    align the destination's stream files to its tick; the carry is
    restored later against the rebuilt program (:func:`restore_carry`)."""
    manifest, leaves, path = load_latest(source_run_dir)
    validate_manifest(manifest, identity)
    tick = int(manifest.get("tick", -1))
    chunk = int(identity.get("chunk") or 0)
    if tick < 0 or (chunk > 0 and tick % chunk != 0):
        raise CheckpointError(
            f"snapshot {path} records tick {tick}, which is not a "
            f"{chunk}-tick chunk boundary — corrupt manifest; refusing "
            "to resume"
        )
    if dest_run_dir is not None:
        _sync_stream_files(source_run_dir, dest_run_dir,
                           (manifest.get("aux") or {}).get("streams") or {})
    return ResumeState(manifest=manifest, leaves=leaves, path=path,
                       source_run_dir=source_run_dir)


# ------------------------------------------------------------ write side


class RunCheckpointer:
    """A run's snapshot writer, driven from the loop's ``observer`` hook
    (after the chunk's plane callbacks, so the stream offsets it records
    are flush-exact): every K-th chunk boundary it reads the carry,
    assembles the manifest, writes atomically, prunes and spans the
    write. A failed write is counted under ``errors`` and warned once; the
    run goes on (``checkpoint.py:686-835``). The span's ``d2h_ms`` times
    the carry's read apart from the write."""

    def __init__(self, run_dir: str, *, every_chunks: int, keep: int, chunk: int,
                 identity: dict, ident: dict, aux_cb=None, spans=None, warn=None,
                 telemetry: bool = False, resumed_from: dict | None = None,
                 export=None):
        self.run_dir = run_dir
        self.export = export
        self.every = max(1, int(every_chunks))
        self.keep = max(1, int(keep))
        self.chunk = max(1, int(chunk))
        self.identity = identity
        self.ident = dict(ident or {})
        self.aux_cb = aux_cb
        self.spans = spans
        self.warn = warn
        self.telemetry = bool(telemetry)
        self.resumed_from = resumed_from
        self.count = 0
        self.last_tick: int | None = None
        self.last_bytes = 0
        self.last_write_ms = 0.0
        self.total_write_ms = 0.0
        self.errors = 0
        self._lat_hist = None  # [G, LATENCY_BINS] int64 mirror
        self._net_mat = None  # [NM_CHANNELS, GH, GH] int64 mirror
        self._warned = False
        self._stage = _HostStage()

    # mirrors of the loop's own accumulators, fed from its callbacks
    def on_lat_delta(self, delta) -> None:
        d = np.asarray(delta, dtype=np.int64)
        self._lat_hist = d if self._lat_hist is None else self._lat_hist + d

    def seed_lat_hist(self, acc) -> None:
        if acc is not None:
            self._lat_hist = np.asarray(acc, dtype=np.int64).copy()

    def on_net_matrix_delta(self, delta) -> None:
        d = np.asarray(delta, dtype=np.int64)
        self._net_mat = d if self._net_mat is None else self._net_mat + d

    def seed_net_matrix(self, acc) -> None:
        if acc is not None:
            self._net_mat = np.asarray(acc, dtype=np.int64).copy()

    def observe(self, ticks: int, carry) -> None:
        if (int(ticks) // self.chunk) % self.every != 0:
            return
        self.snapshot(int(ticks), carry)

    def snapshot(self, ticks: int, carry) -> None:
        try:
            t0 = time.perf_counter()
            leaves, metas = snapshot_carry(
                carry, self.identity.get("transport", "xla"), self._stage,
                export=self.export)
            d2h_ms = (time.perf_counter() - t0) * 1000.0
            aux = dict(self.aux_cb() if self.aux_cb is not None else {})
            aux["lat_hist"] = self._lat_hist is not None
            aux["net_matrix"] = self._net_mat is not None
            manifest = {
                "version": FORMAT_VERSION,
                "tick": int(ticks),
                "chunk_index": int(ticks) // self.chunk,
                "chunk": self.chunk,
                "transport": self.identity.get("transport", "xla"),
                "telemetry": self.telemetry,
                "composition_hash": identity_hash(self.identity, drop=("sources",)),
                "build_key": identity_hash(self.identity),
                "identity": self.identity,
                "leaves": metas,
                "aux": aux,
                "torch": torch.__version__,
                **self.ident,
            }
            path, size, write_ms = save_snapshot(
                self.run_dir, manifest, leaves,
                lat_hist=self._lat_hist, net_matrix=self._net_mat,
            )
            prune_snapshots(self.run_dir, self.keep)
        except Exception as e:  # noqa: BLE001 — never fail the run it protects
            self.errors += 1
            if self.warn is not None and not self._warned:
                self._warned = True
                self.warn("checkpoint at tick %d failed (further failures "
                          "counted silently): %s", int(ticks), e)
            return
        self.count += 1
        self.last_tick = int(ticks)
        self.last_bytes = int(size)
        self.last_write_ms = round(write_ms, 3)
        self.total_write_ms += write_ms
        if self.spans is not None:
            self.spans.point("checkpoint", tick=int(ticks), bytes=int(size),
                             write_ms=round(write_ms, 3), d2h_ms=round(d2h_ms, 3),
                             file=os.path.basename(path))

    def journal(self) -> dict:
        out: dict = {"every_chunks": self.every, "keep": self.keep,
                     "count": self.count, "dir": CHECKPOINT_DIR}
        if self.last_tick is not None:
            out["last_tick"] = self.last_tick
            out["bytes"] = self.last_bytes
            out["write_ms"] = self.last_write_ms
            out["total_write_ms"] = round(self.total_write_ms, 3)
        if self.errors:
            out["errors"] = self.errors
        if self.resumed_from:
            out["resumed"] = dict(self.resumed_from)
        return out
