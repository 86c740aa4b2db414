"""The port's transport (``testground_tpu_torch/sim/net.py`` and the plain
versions of the two kernels in ``sim/cuda_transport.py``) against the JAX
package, on the CPU, bit for bit.

- ``enqueue`` / ``deliver`` of both packages on the same calendar, link
  state, outbox planes and key, under ``transport="xla"`` and, at one small
  shape, ``transport="pallas"`` (the Pallas kernels in interpret mode):
  every plane and every ``NetFeedback`` field.
- ``commit_calendar_plain`` / ``pop_bucket_plain`` against a plain-python
  oracle of the commit semantics, including runs that straddle the
  stream's end and dead keys.

Inputs are made from a seed with numpy and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from testground_tpu.sim import net as jnet
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import net as pnet

FEEDBACK = ("rejected", "clamped", "bw_dropped", "collisions",
            "collision_where", "sent", "enqueued", "fault_dropped")


def _inputs(seed, n=16, o=2, w=2, horizon=8, slots=4, regions=1,
            track_src=True, fanin=False):
    rng = np.random.default_rng(seed)
    ns = n * slots
    fill = rng.random((horizon, ns)) < 0.2
    occ = np.where(fill, rng.integers(1, n + 1, (horizon, ns)), 0).astype(np.int32)
    pays = [rng.integers(-1000, 1000, (horizon, ns)).astype(np.int32)
            for _ in range(w)]
    egress = np.stack([
        rng.uniform(0.5, horizon + 3, n),  # latency: some past the horizon
        rng.uniform(0, 3, n),  # jitter
        np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 8e5, n)),  # bw cap 0..3
        rng.uniform(0, 40, n),  # loss
        rng.uniform(0, 40, n),  # corrupt
        rng.uniform(0, 40, n),  # reorder
        np.zeros(n),  # duplicate (not ported)
    ]).astype(np.float32)
    filters = rng.integers(0, 3, (regions, n)).astype(np.int32)
    region_of = rng.integers(0, regions, n).astype(np.int32)
    hi = 3 if fanin else n + 2
    dst = rng.integers(-2, hi, (o, n)).astype(np.int32)
    payload = rng.integers(-(2**31), 2**31, (o, w, n), dtype=np.int64).astype(np.int32)
    valid = rng.random((o, n)) < 0.85
    return dict(occ=occ if track_src else occ != 0, pays=pays, egress=egress,
                filters=filters, region_of=region_of, dst=dst,
                payload=payload, valid=valid, slots=slots, track_src=track_src)


def _jax_cal(x):
    occ = jnp.asarray(x["occ"])
    return jnet.Calendar(
        payload=tuple(jnp.asarray(p) for p in x["pays"]),
        src=occ if x["track_src"] else None,
        valid=None if x["track_src"] else occ,
        slots=x["slots"], flat=False, horizon=x["occ"].shape[0],
    )


def _port_cal(x):
    occ = torch.from_numpy(x["occ"].copy())
    return pnet.Calendar(
        payload=tuple(torch.from_numpy(p.copy()) for p in x["pays"]),
        src=occ if x["track_src"] else None,
        valid=None if x["track_src"] else occ,
        slots=x["slots"],
    )


def _planes(cal):
    return [np.asarray(cal.occupancy_plane)] + [np.asarray(p) for p in cal.payload]


def _run_both(x, seed, t, features, stacking=True, transport="xla"):
    key = jax.random.key(seed)
    jcal, jfb = jnet.enqueue(
        _jax_cal(x),
        jnet.LinkState(egress=jnp.asarray(x["egress"]),
                       filters=jnp.asarray(x["filters"]),
                       region_of=jnp.asarray(x["region_of"])),
        jnp.asarray(x["dst"]), jnp.asarray(x["payload"]), jnp.asarray(x["valid"]),
        jnp.int32(t), 1.0, key, features=features, stacking=stacking,
        transport=transport,
    )
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    pcal, pfb = pnet.enqueue(
        _port_cal(x),
        pnet.LinkState(egress=torch.from_numpy(x["egress"]),
                       filters=torch.from_numpy(x["filters"]),
                       region_of=torch.from_numpy(x["region_of"])),
        torch.from_numpy(x["dst"]), torch.from_numpy(x["payload"]),
        torch.from_numpy(x["valid"]), torch.tensor(t, dtype=torch.int32),
        1.0, kd, features=features, stacking=stacking,
    )
    return (jcal, jfb), (pcal, pfb)


def _assert_same(j, p, label):
    (jcal, jfb), (pcal, pfb) = j, p
    for i, (a, b) in enumerate(zip(_planes(jcal), _planes(pcal))):
        np.testing.assert_array_equal(b.reshape(a.shape), a, err_msg=f"{label} plane {i}")
    for f in FEEDBACK:
        np.testing.assert_array_equal(
            getattr(pfb, f).numpy(), np.asarray(getattr(jfb, f)),
            err_msg=f"{label} feedback {f}",
        )


SHAPING_CASES = [
    ("latency", ("latency",), 1),
    ("jitter", ("latency", "jitter"), 1),
    ("bandwidth", ("latency", "bandwidth"), 1),
    ("loss", ("latency", "loss"), 1),
    ("corrupt", ("latency", "corrupt"), 1),
    ("reorder", ("latency", "reorder"), 1),
    ("filters-1-region", ("latency", "filters"), 1),
    ("filters-3-regions", ("latency", "filters"), 3),
    ("filters-4-regions", ("latency", "filters"), 4),
    ("filters-6-regions", ("latency", "filters"), 6),
    ("all-but-duplicate", jnet.SHAPING_NO_DUPLICATE, 3),
]


@pytest.mark.parametrize("label,features,regions", SHAPING_CASES,
                         ids=[c[0] for c in SHAPING_CASES])
def test_enqueue_matches_jax_per_feature(label, features, regions):
    for seed in (1, 2):
        x = _inputs(seed, regions=regions)
        _assert_same(*_run_both(x, seed, 13, features), f"{label}/{seed}")


@pytest.mark.parametrize("stacking", [True, False])
@pytest.mark.parametrize("track_src", [True, False], ids=["int32-occ", "bool-occ"])
@pytest.mark.parametrize("fanin", [False, True], ids=["spread", "fan-in"])
def test_enqueue_matches_jax_stacking_and_occupancy(stacking, track_src, fanin):
    """Stacking on/off × int32/bool occupancy × spread/heavy fan-in (slot
    overflow drops) under every ported feature."""
    x = _inputs(5, o=3, w=1, track_src=track_src, fanin=fanin)
    _assert_same(
        *_run_both(x, 5, 6, jnet.SHAPING_NO_DUPLICATE, stacking=stacking),
        f"stacking={stacking}",
    )


@pytest.mark.parametrize("seed", range(10, 20))
def test_enqueue_matches_jax_random_ticks_and_keys(seed):
    """Every ported feature at once over random ticks (bucket wrap-around
    included), keys and fan-in, several ticks into the same calendar."""
    rng = np.random.default_rng(seed)
    x = _inputs(seed, regions=3, fanin=bool(seed % 2))
    jcal, pcal = _jax_cal(x), _port_cal(x)
    for _ in range(3):
        t = int(rng.integers(0, 10_000))
        key_seed = int(rng.integers(0, 2**31))
        y = _inputs(key_seed, regions=3, fanin=bool(seed % 2))
        key = jax.random.key(key_seed)
        jcal, jfb = jnet.enqueue(
            jcal,
            jnet.LinkState(egress=jnp.asarray(x["egress"]),
                           filters=jnp.asarray(x["filters"]),
                           region_of=jnp.asarray(x["region_of"])),
            jnp.asarray(y["dst"]), jnp.asarray(y["payload"]),
            jnp.asarray(y["valid"]), jnp.int32(t), 1.0, key,
            features=jnet.SHAPING_NO_DUPLICATE)
        kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
        pcal, pfb = pnet.enqueue(
            pcal,
            pnet.LinkState(egress=torch.from_numpy(x["egress"]),
                           filters=torch.from_numpy(x["filters"]),
                           region_of=torch.from_numpy(x["region_of"])),
            torch.from_numpy(y["dst"]), torch.from_numpy(y["payload"]),
            torch.from_numpy(y["valid"]), torch.tensor(t, dtype=torch.int32),
            1.0, kd, features=pnet.SHAPING_NO_DUPLICATE)
        _assert_same((jcal, jfb), (pcal, pfb), f"seed {seed} t {t}")


def test_enqueue_matches_jax_pallas_interpret(monkeypatch):
    """The reference's Pallas commit kernel (interpret mode) is the other
    oracle the port's commit must equal. The smallest stream tile keeps
    the interpreter's padded stream short."""
    monkeypatch.setenv("TG_TRANSPORT_TILE", "128")
    x = _inputs(9, n=8, fanin=True)
    _assert_same(
        *_run_both(x, 9, 3, jnet.SHAPING_NO_DUPLICATE, transport="pallas"),
        "pallas",
    )


@pytest.mark.parametrize("transport", ["xla", "pallas"])
@pytest.mark.parametrize("track_src", [True, False], ids=["int32-occ", "bool-occ"])
def test_deliver_matches_jax(transport, track_src):
    x = _inputs(4, n=8, track_src=track_src)
    for t in (0, 3, 11):
        jcal, jin = jnet.deliver(_jax_cal(x), jnp.int32(t), transport=transport)
        pcal, pin = pnet.deliver(_port_cal(x), torch.tensor(t, dtype=torch.int32))
        for a, b in zip(_planes(jcal), _planes(pcal)):
            np.testing.assert_array_equal(b, a)
        for f in ("payload", "src", "valid"):
            np.testing.assert_array_equal(
                getattr(pin, f).numpy(), np.asarray(getattr(jin, f)), err_msg=f
            )


def test_apply_net_updates_matches_jax():
    rng = np.random.default_rng(3)
    n, r = 12, 3
    egress = rng.uniform(0, 9, (7, n)).astype(np.float32)
    filters = rng.integers(0, 3, (r, n)).astype(np.int32)
    region = rng.integers(0, r, n).astype(np.int32)
    upd = [rng.uniform(0, 9, (7, n)).astype(np.float32), rng.random(n) < 0.5,
           rng.integers(0, 3, (r, n)).astype(np.int32), rng.random(n) < 0.5,
           rng.integers(0, r, n).astype(np.int32), rng.random(n) < 0.5]
    j = jnet.apply_net_updates(
        jnet.LinkState(jnp.asarray(egress), jnp.asarray(filters), jnp.asarray(region)),
        *[jnp.asarray(u) for u in upd])
    p = pnet.apply_net_updates(
        pnet.LinkState(torch.from_numpy(egress), torch.from_numpy(filters),
                       torch.from_numpy(region)),
        *[torch.from_numpy(u) for u in upd])
    for f in ("egress", "filters", "region_of"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)))


# ------------------------------------------------- plain kernel versions


def _np_commit(occ0, pays0, sk, occ_vals, pays, t, etick0, n, slots, stacking):
    """Plain-python commit semantics: rank within each (bucket, dst) run
    plus the bucket's PRE-tick fill; survival = slot < SLOTS; keys outside
    [0, L·N) are dead."""
    horizon = occ0.shape[0]
    occ = occ0.copy()
    payp = [p.copy() for p in pays0]
    et = None if etick0 is None else etick0.copy()
    surv = np.zeros(len(sk), np.int32)
    prev, nxt = None, 0
    for j, key in enumerate(int(k) for k in sk):
        if not 0 <= key < horizon * n:
            prev = None
            continue
        b, d = divmod(key, n)
        if key != prev:
            slot = (sum(int(occ0[b, s * n + d] != 0) for s in range(slots))
                    if stacking else 0)
            prev = key
        else:
            slot = nxt
        if slot < slots:
            pos = slot * n + d
            occ[b, pos] = occ_vals[j] if occ.dtype != bool else occ_vals[j] != 0
            for p, v in zip(payp, pays):
                p[b, pos] = v[j]
            if et is not None:
                et[b, pos] = t
            surv[j] = 1
        nxt = slot + 1
    return occ, payp, et, surv


def _stream(draw_keys, horizon, n):
    keys = np.sort(np.asarray(draw_keys, np.int64))
    return np.minimum(keys, horizon * n).astype(np.int32)


@settings(max_examples=40, deadline=None)
@given(
    data=st.data(),
    slots=st.integers(1, 4),
    width=st.integers(1, 3),
    occ_bool=st.booleans(),
    stacking=st.booleans(),
    etick=st.booleans(),
)
def test_commit_calendar_plain_matches_oracle(data, slots, width, occ_bool,
                                              stacking, etick):
    n, horizon = 6, 4
    ns = n * slots
    rng = np.random.default_rng(data.draw(st.integers(0, 2**16)))
    keys = data.draw(st.lists(st.integers(0, horizon * n + 5), min_size=1,
                              max_size=40))
    sk = _stream(keys, horizon, n)
    m2 = len(sk)
    occ0 = np.where(rng.random((horizon, ns)) < 0.3,
                    rng.integers(1, 9, (horizon, ns)), 0).astype(np.int32)
    if occ_bool:
        occ0 = occ0 != 0
    pays0 = [rng.integers(0, 99, (horizon, ns)).astype(np.int32) for _ in range(width)]
    et0 = rng.integers(0, 9, (horizon, ns)).astype(np.int32) if etick else None
    occ_vals = (np.ones(m2) if occ_bool else rng.integers(1, 9, m2)).astype(np.int32)
    pays = [rng.integers(100, 200, m2).astype(np.int32) for _ in range(width)]
    t = 17
    cal = pnet.Calendar(
        payload=tuple(torch.from_numpy(p.copy()) for p in pays0),
        src=None if occ_bool else torch.from_numpy(occ0.copy()),
        valid=torch.from_numpy(occ0.copy()) if occ_bool else None,
        etick=None if et0 is None else torch.from_numpy(et0.copy()),
        slots=slots,
    )
    cal, surv = ct.commit_calendar_plain(
        cal, torch.from_numpy(sk), torch.from_numpy(occ_vals),
        [torch.from_numpy(p) for p in pays], torch.tensor(t, dtype=torch.int32),
        stacking=stacking,
    )
    r_occ, r_pays, r_et, r_surv = _np_commit(
        occ0, pays0, sk, occ_vals, pays, t, et0, n, slots, stacking)
    np.testing.assert_array_equal(cal.occupancy_plane.numpy(), r_occ)
    for a, b in zip(cal.payload, r_pays):
        np.testing.assert_array_equal(a.numpy(), b)
    if etick:
        np.testing.assert_array_equal(cal.etick.numpy(), r_et)
    np.testing.assert_array_equal(surv.numpy(), r_surv)


@pytest.mark.parametrize(
    "keys,want",
    [
        # a 6-message run at the very end of the stream: 4 survive
        ([0, 1, 5, 9, 9, 9, 9, 9, 9], [1, 1, 1, 1, 1, 1, 1, 0, 0]),
        # dead keys (≥ L·N) never survive, wherever they sit
        ([2, 2, 24, 24, 24], [1, 1, 0, 0, 0]),
        # a stream of dead keys only
        ([24, 24], [0, 0]),
    ],
)
def test_commit_calendar_plain_edges(keys, want):
    n, horizon, slots = 6, 4, 4
    cal = pnet.Calendar.empty(horizon, n, slots, 1, device="cpu")
    sk = torch.tensor(keys, dtype=torch.int32)
    cal, surv = ct.commit_calendar_plain(
        cal, sk, torch.arange(1, len(keys) + 1, dtype=torch.int32),
        [sk.clone()], torch.tensor(0, dtype=torch.int32))
    assert surv.tolist() == want


@pytest.mark.parametrize("occ_bool", [False, True])
@pytest.mark.parametrize("t", [0, 5, 13, 2**20 + 1])
def test_pop_bucket_plain_matches_oracle(occ_bool, t):
    rng = np.random.default_rng(t)
    horizon, ns, w = 8, 20, 2
    occ0 = rng.integers(0, 4, (horizon, ns)).astype(np.int32)
    if occ_bool:
        occ0 = occ0 != 0
    pays = [rng.integers(0, 99, (horizon, ns)).astype(np.int32) for _ in range(w)]
    cal = pnet.Calendar(
        payload=tuple(torch.from_numpy(p.copy()) for p in pays),
        src=None if occ_bool else torch.from_numpy(occ0.copy()),
        valid=torch.from_numpy(occ0.copy()) if occ_bool else None,
        slots=4,
    )
    cal, row, pay_rows = ct.pop_bucket_plain(cal, torch.tensor(t, dtype=torch.int32))
    b = t % horizon
    np.testing.assert_array_equal(row.numpy(), occ0[b])
    for r, p in zip(pay_rows, pays):
        np.testing.assert_array_equal(r.numpy(), p[b])
    want = occ0.copy()
    want[b] = 0
    np.testing.assert_array_equal(cal.occupancy_plane.numpy(), want)
    for a, p in zip(cal.payload, pays):
        np.testing.assert_array_equal(a.numpy(), p)
