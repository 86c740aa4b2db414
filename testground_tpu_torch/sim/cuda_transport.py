"""The calendar transport's two kernels: CUDA C++ for Hopper, with their
plain PyTorch versions.

Port of ``testground_tpu/sim/pallas_transport.py``. Same public names and
return contracts:

- :func:`commit_calendar` — K1, the segmented calendar commit
  (``pallas_transport.py:_commit_call`` via ``commit_calendar``).
- :func:`pop_bucket` — K2, the delivery pop
  (``pallas_transport.py:_pop_call`` via ``pop_bucket``).
- :func:`commit_calendar_sharded` and :func:`pop_bucket_sharded` — K1 and
  K2 on a mesh of peer shards (``_commit_calendar_sharded``,
  ``_pop_bucket_sharded``): one launch per device over the shards it
  holds, on the calendar of ``net.Calendar`` with a mesh. The sharded
  pop's segment geometry (:func:`pop_segments`) is computed here and
  handed to the kernel, so the CPU tests reach it. On a cohort mesh
  (``sim/distributed.py``) each process launches over its own parts, and
  the combine crosses processes: the survival masks are summed by one
  ``all_reduce`` and the popped rows gathered by one ``all_gather``
  (:func:`cohort_rows`).

The kernels live in ``csrc/transport.cu`` (design and bound notes there).
They are compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` at first use
— never at import — and rebuilt when the source's hash changes; the plain C
interface is loaded with ``ctypes``.

Routing is by the tensors' device and nothing else: a CPU tensor takes the
plain version (what the CPU tests run); a CUDA tensor launches the kernel,
and anything the kernel does not take raises. There is no fallback from
one to the other. Each wrapper counts its kernel launches in a plain
integer attribute (``commit_calendar.launches``, ``pop_bucket.launches``)
so a run can show that its main path went through the kernels.

:func:`commit_bytes` and :func:`pop_bytes` are the closed forms of the
bytes each kernel must move (each input read once, each output written
once): the memory bound that ``chip_smoke.py`` holds the kernels'
times against, and what the phase ledger (``sim/phases.py``) adds for a
launch its dispatch counter cannot see. Inside :func:`observe_launches`
each wrapper that launches a kernel reports the launch to the thread's
observer; without an observer the wrappers read nothing.

The kernels update the calendar planes IN PLACE (the JAX package returns
new arrays; the port mutates, which saves a copy of every plane a tick).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

__all__ = [
    "COMMIT_TILE",
    "MAX_WIDTH",
    "PopSegments",
    "build_kernels",
    "commit_bytes",
    "commit_calendar",
    "commit_calendar_plain",
    "commit_calendar_sharded",
    "commit_calendar_sharded_plain",
    "cohort_rows",
    "observe_launches",
    "pop_bucket",
    "pop_bucket_plain",
    "pop_bytes",
    "pop_bucket_sharded",
    "pop_bucket_sharded_plain",
    "pop_segments",
]

# payload planes one launch addresses (TG_MAX_WIDTH in transport.cu)
MAX_WIDTH = 8
# sorted messages one K1 block commits (kCommitTile in transport.cu)
COMMIT_TILE = 256

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG, "csrc", "transport.cu")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found: the transport kernels are built from "
        f"{_SOURCE} with the CUDA toolkit on the machine with the GPU"
    )


# the first build may be asked for by several threads at once (a daemon's
# workers): one of them runs nvcc, the others then find its library
_BUILD_LOCK = threading.Lock()


def build_kernels() -> tuple[str, float, str]:
    """Compile ``csrc/transport.cu`` unless a library built from the same
    source bytes and flags exists. Returns ``(path, seconds, compiler
    output)``; seconds is 0.0 on a cache hit."""
    with _BUILD_LOCK:
        return _build_kernels()


def _build_kernels() -> tuple[str, float, str]:
    with open(_SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"transport_{digest}.so")
    if os.path.isfile(out):
        return out, 0.0, ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, _SOURCE],
            capture_output=True,
            text=True,
            check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out, time.perf_counter() - t0, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    path, _, _ = build_kernels()
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tg_commit_calendar.argtypes = [
        vp, vp, vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp,
    ]
    lib.tg_commit_calendar.restype = ci
    lib.tg_pop_bucket.argtypes = [
        vp, ci, vp, ci, vp, ci, ctypes.c_longlong, vp, vp, vp,
    ]
    lib.tg_pop_bucket.restype = ci
    lib.tg_commit_calendar_sharded.argtypes = [
        vp, vp, vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, vp,
    ]
    lib.tg_commit_calendar_sharded.restype = ci
    ll = ctypes.c_longlong
    lib.tg_pop_bucket_sharded.argtypes = [
        vp, ci, vp, ci, vp, ci, ci, ci, ci, ll, ll, ll, ll, ll, ll, vp, vp, vp,
    ]
    lib.tg_pop_bucket_sharded.restype = ci
    return lib


def _ptr_array(tensors) -> ctypes.Array:
    arr = (ctypes.c_void_p * MAX_WIDTH)()
    for i, x in enumerate(tensors):
        arr[i] = x.data_ptr()
    return arr


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"cuda_transport: {what}")


def _check_planes(cal) -> None:
    occ = cal.occupancy_plane
    _require(occ.dim() == 2, f"occupancy plane must be 2-D, got {occ.shape}")
    _require(
        occ.dtype in (torch.int32, torch.bool),
        f"occupancy plane must be int32 or bool, got {occ.dtype}",
    )
    _require(0 < cal.width <= MAX_WIDTH, f"payload width {cal.width}")
    planes = [occ, *cal.payload] + ([cal.etick] if cal.etick is not None else [])
    for p in planes:
        _require(p.is_contiguous(), "calendar planes must be contiguous")
        _require(p.device == occ.device, "calendar planes on mixed devices")
        _require(p.shape == occ.shape, "calendar planes of unequal shapes")
    for p in planes[1:]:
        _require(p.dtype == torch.int32, "payload/etick planes must be int32")
    _require(occ.shape[1] % cal.slots == 0, "N·SLOTS axis not a SLOTS multiple")


def _check_stream(cal, sk, occ_vals, pay_sorted, dev) -> None:
    m2 = sk.shape[0]
    _require(len(pay_sorted) == cal.width, "one sorted stream per payload plane")
    for x in (sk, occ_vals, *pay_sorted):
        _require(
            x.dtype == torch.int32
            and x.dim() == 1
            and x.shape[0] == m2
            and x.is_contiguous()
            and x.device == dev,
            "stream operands must be contiguous [m2] int32 on the planes' device",
        )


def _check_tick(t: torch.Tensor, device) -> None:
    _require(
        isinstance(t, torch.Tensor)
        and t.dtype == torch.int32
        and t.numel() == 1
        and t.device == device,
        "t must be a one-element int32 tensor on the planes' device",
    )


# ----------------------------------------------------- bytes and observer


def commit_bytes(m2: int, width: int, slots: int, occ_bool: bool, stacking: bool,
                 etick: bool, runs: int, survivors: int) -> int:
    """The bytes K1 must move on one stream: the keys, occupancy marks and
    ``width`` payload streams read (``m2`` int32 each) and the survival
    mask written, the pre-tick fill of each of the stream's ``runs``
    distinct live keys read under ``stacking`` (``slots`` occupancy cells
    each), and each of the ``survivors``' occupancy, payload and etick
    cells written."""
    occ_b = 1 if occ_bool else 4
    return (m2 * (8 + 4 * width) + m2 * 4
            + (runs * slots * occ_b if stacking else 0)
            + survivors * (occ_b + 4 * width + (4 if etick else 0)))


def pop_bytes(cells: int, width: int, occ_bool: bool) -> int:
    """The bytes K2 must move popping a row of ``cells`` (N·SLOTS) cells:
    the occupancy and ``width`` payload rows read and written out, and the
    occupancy row cleared."""
    occ_b = 1 if occ_bool else 4
    return cells * (occ_b + 4 * width) * 2 + cells * occ_b


_OBSERVED = threading.local()


@contextlib.contextmanager
def observe_launches(fn):
    """Within the block, each kernel launch of this thread calls ``fn(name,
    measure)`` with the wrapper's name and a function that returns the
    launch's closed-form bytes (:func:`commit_bytes`, :func:`pop_bytes`);
    a sharded wrapper reports once for all its launches. K1's ``measure``
    reads the stream's run and survivor counts off the card (torch ops,
    which wait for the stream), so the observer chooses when they run."""
    prev = getattr(_OBSERVED, "fn", None)
    _OBSERVED.fn = fn
    try:
        yield
    finally:
        _OBSERVED.fn = prev


def _occ_bool(cal) -> bool:
    occ = cal.occupancy_plane
    return (occ if cal.mesh is None else occ[0]).dtype == torch.bool


def _report_commit(name, cal, sk, surv, big, stacking) -> None:
    """Report a K1 wrapper's launch to the thread's observer, if any."""
    fn = getattr(_OBSERVED, "fn", None)
    if fn is None:
        return

    def measure() -> int:
        live = sk < big
        starts = torch.ones_like(live)
        starts[1:] = sk[1:] != sk[:-1]
        return commit_bytes(sk.shape[0], cal.width, cal.slots, _occ_bool(cal),
                            stacking, cal.etick is not None,
                            int((live & starts).sum()), int(surv.sum()))

    fn(name, measure)


def _report_pop(name, cal, cells) -> None:
    fn = getattr(_OBSERVED, "fn", None)
    if fn is not None:
        fn(name, lambda: pop_bytes(cells, cal.width, _occ_bool(cal)))


# ------------------------------------------------------------------ K1


def _commit_plain(cal, sk, occ_vals, pay_sorted, t, stacking, key_lo=0):
    """The plain commit into ``cal``'s 2-D ``[rows, SLOTS·n]`` planes of the
    messages whose key lies in ``[key_lo, key_lo + rows·n)``, at local key
    ``key - key_lo``; the others are left alone and read survived = 0."""
    occ = cal.occupancy_plane
    rows, ns = occ.shape
    slots = cal.slots
    n = ns // slots
    m2 = sk.shape[0]
    dev = sk.device
    pos = torch.arange(m2, dtype=torch.int64, device=dev)
    is_start = torch.ones(m2, dtype=torch.bool, device=dev)
    is_start[1:] = sk[1:] != sk[:-1]
    starts = torch.where(is_start, pos, torch.zeros_like(pos))
    rank = pos - torch.cummax(starts, dim=0).values
    skl = sk.to(torch.int64) - key_lo
    big = rows * n
    live = (skl >= 0) & (skl < big)
    if stacking:
        fill = (occ.reshape(rows, slots, n) != 0).sum(dim=1, dtype=torch.int64)
        base = fill.reshape(-1)[skl.clamp(0, big - 1)]
        rank = rank + torch.where(live, base, torch.zeros_like(base))
    surv = live & (rank < slots)
    keys = skl[surv]
    b = torch.div(keys, n, rounding_mode="floor")
    p = rank[surv] * n + (keys - b * n)
    if occ.dtype == torch.bool:
        occ.index_put_((b, p), occ_vals[surv] != 0)
    else:
        occ.index_put_((b, p), occ_vals[surv])
    for plane, vals in zip(cal.payload, pay_sorted):
        plane.index_put_((b, p), vals[surv])
    if cal.etick is not None:
        cal.etick.index_put_(
            (b, p), t.reshape(()).to(torch.int32).expand(b.shape[0])
        )
    return surv.to(torch.int32)


def commit_calendar_plain(cal, sk, occ_vals, pay_sorted, t, *, stacking=True):
    """Plain PyTorch K1, mirroring the reference's XLA path
    (``net.py:1242-1299``): rank = position − the prefix-max of run
    starts, plus the bucket's pre-tick fill (gathered before any write),
    then masked ``index_put_`` of every plane. Runs on any device; returns
    ``(cal, survived)`` with ``survived`` an ``[m2]`` int32 0/1 mask in
    sorted order."""
    return cal, _commit_plain(cal, sk, occ_vals, pay_sorted, t, stacking)


def commit_calendar(cal, sk, occ_vals, pay_sorted, t, *, stacking=True):
    """Commit one tick's sorted message stream into the calendar planes.

    ``sk`` [m2] int32 sorted keys (bucket·N + dst; ≥ L·N = dead),
    ``occ_vals`` [m2] int32 occupancy marks (src+1, or 1), ``pay_sorted``
    W × [m2] int32 sorted alongside, ``t`` the tick (one-element int32, on
    the planes' device; written to the etick plane when it exists).
    Returns ``(cal, survived)``; the planes are updated in place."""
    if sk.device.type == "cpu":
        return commit_calendar_plain(
            cal, sk, occ_vals, pay_sorted, t, stacking=stacking
        )
    _require(sk.device.type == "cuda", f"unsupported device {sk.device}")
    _check_planes(cal)
    occ = cal.occupancy_plane
    dev = occ.device
    m2 = sk.shape[0]
    _check_stream(cal, sk, occ_vals, pay_sorted, dev)
    _check_tick(t, dev)
    horizon, ns = occ.shape
    n = ns // cal.slots
    _require(horizon * ns < 2**31, "calendar too large for int32 keys")
    surv = torch.empty(m2, dtype=torch.int32, device=dev)
    if m2 == 0:
        return cal, surv
    lib = _lib()
    pay_ptrs = _ptr_array(pay_sorted)
    plane_ptrs = _ptr_array(cal.payload)
    rc = lib.tg_commit_calendar(
        sk.data_ptr(),
        occ_vals.data_ptr(),
        ctypes.addressof(pay_ptrs),
        cal.width,
        occ.data_ptr(),
        int(occ.dtype == torch.bool),
        ctypes.addressof(plane_ptrs),
        cal.etick.data_ptr() if cal.etick is not None else None,
        t.data_ptr(),
        surv.data_ptr(),
        m2,
        horizon,
        n,
        cal.slots,
        int(bool(stacking)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"commit_calendar kernel launch failed: CUDA error {rc}")
    commit_calendar.launches += 1
    _report_commit("commit_calendar", cal, sk, surv, horizon * n, stacking)
    return cal, surv


commit_calendar.launches = 0


# ------------------------------------------------------------------ K2


def pop_bucket_plain(cal, t):
    """Plain PyTorch K2, mirroring the reference's XLA ``deliver``
    (``net.py:366-413``): copy row ``t mod L`` of the occupancy and payload
    planes, then zero the occupancy row. Returns ``(cal, occ_row,
    pay_rows)``."""
    occ = cal.occupancy_plane
    b = int(torch.remainder(t.reshape(()), occ.shape[0]))
    occ_row = occ[b].clone()
    pay_rows = [p[b].clone() for p in cal.payload]
    occ[b].zero_()
    return cal, occ_row, pay_rows


def pop_bucket(cal, t):
    """Pop the bucket arriving at tick ``t``: returns ``(cal, occ_row,
    pay_rows)`` with the rows as [N·SLOTS] vectors; the occupancy row is
    cleared in place (payload stays stale but masked)."""
    occ = cal.occupancy_plane
    if occ.device.type == "cpu":
        return pop_bucket_plain(cal, t)
    _require(occ.device.type == "cuda", f"unsupported device {occ.device}")
    _check_planes(cal)
    dev = occ.device
    _check_tick(t, dev)
    horizon, ns = occ.shape
    lib = _lib()
    row_occ = torch.empty(ns, dtype=occ.dtype, device=dev)
    rows = [torch.empty(ns, dtype=torch.int32, device=dev) for _ in cal.payload]
    pay_ptrs = _ptr_array(cal.payload)
    row_ptrs = _ptr_array(rows)
    rc = lib.tg_pop_bucket(
        occ.data_ptr(),
        int(occ.dtype == torch.bool),
        ctypes.addressof(pay_ptrs),
        cal.width,
        t.data_ptr(),
        horizon,
        ns,
        row_occ.data_ptr(),
        ctypes.addressof(row_ptrs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"pop_bucket kernel launch failed: CUDA error {rc}")
    pop_bucket.launches += 1
    _report_pop("pop_bucket", cal, ns)
    return cal, row_occ, rows


pop_bucket.launches = 0


# ------------------------------------------------------------ on a mesh
#
# A meshed ``net.Calendar`` holds each plane as one ``[S_d, L, SLOTS·n_loc]``
# tensor per mesh part (``meshplan.TorchMesh.parts``: a device and its
# shards [s0, s1)); ``cal.part(i)`` is part i as a 2-D ``[S_d·L,
# SLOTS·n_loc]`` calendar of views. The stream is sorted by the shard-major
# key ``s·L·n_loc + bucket·n_loc + dst mod n_loc`` (big = L·N still sorts
# last), so part i's messages are exactly those with a key in [s0·L·n_loc,
# s1·L·n_loc), and ``key - s0·L·n_loc`` is their key in the part's plane.


def _device_context(dev, several: bool):
    """The launch's device made current, where a mesh spans devices."""
    return torch.cuda.device(dev) if several else contextlib.nullcontext()


def commit_calendar_sharded_plain(cal, sk, occ_vals, pay_sorted, t, *, stacking=True):
    """Plain PyTorch sharded K1: the plain commit of every part's segment
    of the shard-major stream into its planes, the per-part survival masks
    summed on the stream's device (``pallas_transport.py:661``)."""
    dev0 = sk.device
    seg = cal.horizon * cal.n_loc
    survived = None
    for i, (dev, s0, _) in enumerate(cal.mesh.parts):
        surv = _commit_plain(
            cal.part(i), sk.to(dev), occ_vals.to(dev), [p.to(dev) for p in pay_sorted],
            t.to(dev), stacking, key_lo=s0 * seg,
        ).to(dev0)
        survived = surv if survived is None else survived + surv
    return cal, _cohort_sum(cal, survived)


def _cohort_sum(cal, survived):
    """A cohort's survival mask: every process's parts summed."""
    if not cal.mesh.cohort:
        return survived
    from .distributed import all_reduce_sum

    return all_reduce_sum(survived)


def cohort_rows(rows: list) -> list:
    """A cohort's global slot-major rows from this process's: ``rows`` is
    one ``[SLOTS, S_p·n_loc]`` tensor per plane (the lanes of this
    process's cells), all gathered in ONE collective into ``[SLOTS·N]``
    rows, the ranks' lanes in rank order."""
    from .distributed import all_gather

    block = torch.stack([r.to(torch.int32) for r in rows])
    every = all_gather(block)  # [P, planes, SLOTS, S_p·n_loc]
    glob = every.permute(1, 2, 0, 3).reshape(len(rows), -1)
    return [g if r.dtype == torch.int32 else g.to(r.dtype)
            for g, r in zip(glob.unbind(0), rows)]


def commit_calendar_sharded(cal, sk, occ_vals, pay_sorted, t, *, stacking=True):
    """Commit one tick's shard-major sorted stream into a meshed calendar:
    one launch per mesh part. Arguments and return as
    :func:`commit_calendar`; ``survived`` lies on the stream's device."""
    if sk.device.type == "cpu":
        return commit_calendar_sharded_plain(
            cal, sk, occ_vals, pay_sorted, t, stacking=stacking
        )
    _require(sk.device.type == "cuda", f"unsupported device {sk.device}")
    parts = cal.mesh.parts
    several = len(parts) > 1
    seg = cal.horizon * cal.n_loc
    _require(cal.mesh.size * seg < 2**31, "calendar too large for int32 keys")
    m2 = sk.shape[0]
    _check_stream(cal, sk, occ_vals, pay_sorted, sk.device)
    _check_tick(t, sk.device)
    if m2 == 0:
        return cal, torch.empty(0, dtype=torch.int32, device=sk.device)
    lib = _lib()
    survived = None
    for i, (dev, s0, s1) in enumerate(parts):
        part = cal.part(i)
        _check_planes(part)
        _require(part.occupancy_plane.device == dev, "mesh part off its device")
        stream = [x.to(dev) for x in (sk, occ_vals, *pay_sorted)]
        t_d = t.to(dev)
        # a part that holds every shard owns the whole mask; the others
        # write their own segment into a zeroed mask
        own_all = not several and not cal.mesh.cohort
        alloc = torch.empty if own_all else torch.zeros
        surv = alloc(m2, dtype=torch.int32, device=dev)
        pay_ptrs = _ptr_array(stream[2:])
        plane_ptrs = _ptr_array(part.payload)
        occ = part.occupancy_plane
        with _device_context(dev, several):
            rc = lib.tg_commit_calendar_sharded(
                stream[0].data_ptr(),
                stream[1].data_ptr(),
                ctypes.addressof(pay_ptrs),
                part.width,
                occ.data_ptr(),
                int(occ.dtype == torch.bool),
                ctypes.addressof(plane_ptrs),
                part.etick.data_ptr() if part.etick is not None else None,
                t_d.data_ptr(),
                surv.data_ptr(),
                m2,
                (s1 - s0) * cal.horizon,
                cal.n_loc,
                part.slots,
                int(bool(stacking)),
                s0 * seg,
                int(own_all),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(
                f"commit_calendar_sharded kernel launch failed: CUDA error {rc}"
            )
        commit_calendar_sharded.launches += 1
        surv = surv.to(sk.device)
        survived = surv if survived is None else survived + surv
    survived = _cohort_sum(cal, survived)
    _report_commit("commit_calendar_sharded", cal, sk, survived,
                   cal.mesh.size * seg, stacking)
    return cal, survived


commit_calendar_sharded.launches = 0


def pop_bucket_sharded_plain(cal, t):
    """Plain PyTorch sharded K2: row ``t mod L`` of every shard's planes,
    laid along the lane axis into the global slot-major ``[SLOTS·N]`` rows
    on the primary device; every shard's occupancy row cleared."""
    slots, n_loc, n = cal.slots, cal.n_loc, cal.lanes
    dev0 = cal.mesh.primary
    b = int(torch.remainder(t.reshape(()), cal.horizon))
    occ_parts = cal.occupancy_plane
    if cal.mesh.cohort:
        local = [
            torch.cat([p[:, b].reshape(s1 - s0, slots, n_loc).permute(1, 0, 2)
                       .reshape(slots, -1) for p, (_, s0, s1) in zip(plane, cal.mesh.parts)],
                      dim=1)
            for plane in (occ_parts, *cal.payload)
        ]
        for p in occ_parts:
            p[:, b].zero_()
        occ_row, *pay_rows = cohort_rows(local)
        return cal, occ_row, pay_rows
    occ_row = torch.empty(slots * n, dtype=occ_parts[0].dtype, device=dev0)
    pay_rows = [torch.empty(slots * n, dtype=torch.int32, device=dev0)
                for _ in range(cal.width)]
    for i, (_, s0, s1) in enumerate(cal.mesh.parts):
        for row, plane in ((occ_row, occ_parts[i]),
                           *zip(pay_rows, (p[i] for p in cal.payload))):
            src = plane[:, b].reshape(s1 - s0, slots, n_loc).permute(1, 0, 2)
            row.view(slots, n)[:, s0 * n_loc : s1 * n_loc].copy_(
                src.reshape(slots, (s1 - s0) * n_loc)
            )
        occ_parts[i][:, b].zero_()
    return cal, occ_row, pay_rows


@dataclasses.dataclass(frozen=True)
class PopSegments:
    """Where the sharded pop's segments lie, in cells. A mesh part's pop
    is ``shards × slots`` runs of ``length`` cells: for the part's own
    shard index ``s`` and a slot, bucket row ``b``'s cells start at
    ``s·src_shard + slot·src_slot + b·src_row`` of every ``[S_d·L,
    SLOTS·n_loc]`` plane and land at ``dst0 + s·dst_shard +
    slot·dst_slot`` of every output row. The kernel walks exactly these
    runs (``tg_pop_bucket_sharded``)."""

    shards: int
    slots: int
    length: int
    src_shard: int
    src_slot: int
    src_row: int
    dst_shard: int
    dst_slot: int
    dst0: int


def pop_segments(cal, i: int, home: bool) -> PopSegments:
    """Mesh part ``i``'s segments: into the global slot-major ``[SLOTS·N]``
    row where the part lies on the primary device (``home``), else into a
    part-local ``[SLOTS, S_d·n_loc]`` row that is then copied home."""
    _, s0, s1 = cal.mesh.parts[i]
    slots, n_loc = cal.slots, cal.n_loc
    out_stride, out_col0 = (cal.lanes, s0 * n_loc) if home else ((s1 - s0) * n_loc, 0)
    return PopSegments(
        shards=s1 - s0, slots=slots, length=n_loc,
        src_shard=cal.horizon * slots * n_loc, src_slot=n_loc, src_row=slots * n_loc,
        dst_shard=n_loc, dst_slot=out_stride, dst0=out_col0,
    )


def pop_bucket_sharded(cal, t):
    """Pop the bucket arriving at tick ``t`` from a meshed calendar: one
    launch per mesh part. Returns ``(cal, occ_row, pay_rows)`` as
    :func:`pop_bucket`, the rows global and slot-major on the primary
    device; each shard's occupancy row is cleared in place."""
    occ_parts = cal.occupancy_plane
    if occ_parts[0].device.type == "cpu":
        return pop_bucket_sharded_plain(cal, t)
    _require(
        occ_parts[0].device.type == "cuda", f"unsupported device {occ_parts[0].device}"
    )
    slots, n_loc, n = cal.slots, cal.n_loc, cal.lanes
    dev0 = cal.mesh.primary
    parts = cal.mesh.parts
    several = len(parts) > 1
    cohort = cal.mesh.cohort
    lib = _lib()
    local = []  # a cohort's part-local rows, gathered below
    if not cohort:
        row_occ = torch.empty(slots * n, dtype=occ_parts[0].dtype, device=dev0)
        rows = [torch.empty(slots * n, dtype=torch.int32, device=dev0)
                for _ in range(cal.width)]
    for i, (dev, s0, s1) in enumerate(parts):
        part = cal.part(i)
        _check_planes(part)
        t_d = t.to(dev)
        _check_tick(t_d, dev)
        home = dev == dev0 and not cohort
        seg = pop_segments(cal, i, home)
        if home:  # straight into the global row
            out_occ, out_pay = row_occ, rows
        else:  # a device-local row, copied home below
            cells = seg.shards * seg.slots * seg.length
            out_occ = torch.empty(cells, dtype=occ_parts[0].dtype, device=dev)
            out_pay = [torch.empty(cells, dtype=torch.int32, device=dev)
                       for _ in range(cal.width)]
        pay_ptrs = _ptr_array(part.payload)
        row_ptrs = _ptr_array(out_pay)
        occ = part.occupancy_plane
        with _device_context(dev, several):
            rc = lib.tg_pop_bucket_sharded(
                occ.data_ptr(),
                int(occ.dtype == torch.bool),
                ctypes.addressof(pay_ptrs),
                part.width,
                t_d.data_ptr(),
                cal.horizon,
                seg.shards,
                seg.slots,
                seg.length,
                seg.src_shard,
                seg.src_slot,
                seg.src_row,
                seg.dst_shard,
                seg.dst_slot,
                seg.dst0,
                out_occ.data_ptr(),
                ctypes.addressof(row_ptrs),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if rc != 0:
            raise RuntimeError(f"pop_bucket_sharded kernel launch failed: CUDA error {rc}")
        pop_bucket_sharded.launches += 1
        if cohort:
            local.append([x.view(slots, -1) for x in (out_occ, *out_pay)])
        elif not home:
            for glob, loc in ((row_occ, out_occ), *zip(rows, out_pay)):
                glob.view(slots, n)[:, s0 * n_loc : s1 * n_loc].copy_(
                    loc.view(slots, (s1 - s0) * n_loc)
                )
    if cohort:
        row_occ, *rows = cohort_rows([torch.cat(x, dim=1) for x in zip(*local)])
    _report_pop("pop_bucket_sharded", cal, slots * n)
    return cal, row_occ, rows


pop_bucket_sharded.launches = 0
