"""The calendar transport's two kernels: CUDA C++ for Hopper, with their
plain PyTorch versions.

Port of ``testground_tpu/sim/pallas_transport.py``. Same public names and
return contracts:

- :func:`commit_calendar` — K1, the segmented calendar commit
  (``pallas_transport.py:_commit_call`` via ``commit_calendar``).
- :func:`pop_bucket` — K2, the delivery pop
  (``pallas_transport.py:_pop_call`` via ``pop_bucket``).

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

Both kernels update the calendar planes IN PLACE (the JAX package returns
new arrays; the port mutates, which saves a copy of every plane a tick).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

__all__ = [
    "COMMIT_TILE",
    "MAX_WIDTH",
    "build_kernels",
    "commit_calendar",
    "commit_calendar_plain",
    "pop_bucket",
    "pop_bucket_plain",
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


def build_kernels() -> tuple[str, float, str]:
    """Compile ``csrc/transport.cu`` unless a library built from the same
    source bytes and flags exists. Returns ``(path, seconds, compiler
    output)``; seconds is 0.0 on a cache hit."""
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


def _check_tick(t: torch.Tensor, device) -> None:
    _require(
        isinstance(t, torch.Tensor)
        and t.dtype == torch.int32
        and t.numel() == 1
        and t.device == device,
        "t must be a one-element int32 tensor on the planes' device",
    )


# ------------------------------------------------------------------ K1


def commit_calendar_plain(cal, sk, occ_vals, pay_sorted, t, *, stacking=True):
    """Plain PyTorch K1, mirroring the reference's XLA path
    (``net.py:1242-1299``): rank = position − the prefix-max of run
    starts, plus the bucket's pre-tick fill (gathered before any write),
    then masked ``index_put_`` of every plane. Runs on any device; returns
    ``(cal, survived)`` with ``survived`` an ``[m2]`` int32 0/1 mask in
    sorted order."""
    occ = cal.occupancy_plane
    horizon, ns = occ.shape
    slots = cal.slots
    n = ns // slots
    m2 = sk.shape[0]
    big = horizon * n
    dev = sk.device
    pos = torch.arange(m2, dtype=torch.int64, device=dev)
    is_start = torch.ones(m2, dtype=torch.bool, device=dev)
    is_start[1:] = sk[1:] != sk[:-1]
    starts = torch.where(is_start, pos, torch.zeros_like(pos))
    rank = pos - torch.cummax(starts, dim=0).values
    live = (sk >= 0) & (sk < big)
    skl = sk.to(torch.int64)
    if stacking:
        fill = (occ.reshape(horizon, slots, n) != 0).sum(
            dim=1, dtype=torch.int64
        )
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
    return cal, surv.to(torch.int32)


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
    return cal, row_occ, rows


pop_bucket.launches = 0
