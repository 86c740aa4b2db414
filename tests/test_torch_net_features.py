"""The port's ``enqueue`` features beyond the sorted path's latency, dice
and region filters, against the JAX package on the CPU, bit for bit:
direct slot mode (clean, and under ``validate`` with forced collisions),
duplicate shaping, the HTB ``bandwidth_queue`` (several ticks, a rate
change under a standing backlog, queue overflow) and per-instance
``filter_rules``; plus
``make_link_state`` and ``apply_net_updates`` with the new leaves.

Inputs are made from a seed with numpy and handed to both packages. No
tolerance anywhere: the float32 backlog is compared bit for bit too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from testground_tpu.sim import net as jnet
from testground_tpu_torch.sim import net as pnet

FEEDBACK = ("rejected", "clamped", "bw_dropped", "collisions",
            "collision_where", "sent", "enqueued", "fault_dropped")


def _inputs(seed, n=16, o=2, w=2, horizon=8, slots=4, track_src=True,
            fill=0.2, dup_pct=(0, 60), bw_msgs=(0.3, 3.0), n_rules=0):
    rng = np.random.default_rng(seed)
    ns = n * slots
    occ = np.where(rng.random((horizon, ns)) < fill,
                   rng.integers(1, n + 1, (horizon, ns)), 0).astype(np.int32)
    pays = [rng.integers(-1000, 1000, (horizon, ns)).astype(np.int32) for _ in range(w)]
    bw = np.where(rng.random(n) < 0.3, 0.0,
                  rng.uniform(*bw_msgs, n) * jnet.MSG_BYTES * 1000.0)
    egress = np.stack([
        rng.uniform(0.5, horizon + 2, n),  # latency: some past the horizon
        rng.uniform(0, 3, n),  # jitter
        bw,  # bandwidth, bytes/s
        rng.uniform(0, 30, n),  # loss
        rng.uniform(0, 30, n),  # corrupt
        rng.uniform(0, 30, n),  # reorder
        rng.uniform(*dup_pct, n),  # duplicate
    ]).astype(np.float32)
    rules = None
    if n_rules:
        start = rng.integers(0, n, (n_rules, n))
        rules = np.stack([start, start + rng.integers(-1, 9, (n_rules, n)),
                          rng.integers(0, 3, (n_rules, n))], axis=1).astype(np.int32)
    return dict(
        occ=occ if track_src else occ != 0, pays=pays, egress=egress,
        filters=rng.integers(0, 3, (3, n)).astype(np.int32),
        region_of=rng.integers(0, 3, n).astype(np.int32),
        backlog=np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 6, n)).astype(np.float32),
        rules=rules,
        dst=rng.integers(-2, n + 2, (o, n)).astype(np.int32),
        payload=rng.integers(-(2**31), 2**31, (o, w, n), dtype=np.int64).astype(np.int32),
        valid=rng.random((o, n)) < 0.85,
        slots=slots, track_src=track_src,
    )


def _jax_state(x, backlog=False):
    occ = jnp.asarray(x["occ"])
    cal = jnet.Calendar(payload=tuple(jnp.asarray(p) for p in x["pays"]),
                        src=occ if x["track_src"] else None,
                        valid=None if x["track_src"] else occ,
                        slots=x["slots"], flat=False, horizon=x["occ"].shape[0])
    link = jnet.LinkState(
        egress=jnp.asarray(x["egress"]), filters=jnp.asarray(x["filters"]),
        region_of=jnp.asarray(x["region_of"]),
        backlog=jnp.asarray(x["backlog"]) if backlog else None,
        rules=None if x["rules"] is None else jnp.asarray(x["rules"]))
    return cal, link


def _port_state(x, backlog=False):
    occ = torch.from_numpy(x["occ"].copy())
    cal = pnet.Calendar(payload=tuple(torch.from_numpy(p.copy()) for p in x["pays"]),
                        src=occ if x["track_src"] else None,
                        valid=None if x["track_src"] else occ, slots=x["slots"])
    link = pnet.LinkState(
        egress=torch.from_numpy(x["egress"]), filters=torch.from_numpy(x["filters"]),
        region_of=torch.from_numpy(x["region_of"]),
        backlog=torch.from_numpy(x["backlog"]) if backlog else None,
        rules=None if x["rules"] is None else torch.from_numpy(x["rules"]))
    return cal, link


def _enqueue_both(jstate, pstate, x, t, key_seed, features, **kw):
    key = jax.random.key(key_seed)
    jcal, jfb = jnet.enqueue(
        *jstate, jnp.asarray(x["dst"]), jnp.asarray(x["payload"]),
        jnp.asarray(x["valid"]), jnp.int32(t), 1.0, key, features=features, **kw)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    pcal, pfb = pnet.enqueue(
        *pstate, torch.from_numpy(x["dst"]), torch.from_numpy(x["payload"]),
        torch.from_numpy(x["valid"]), torch.tensor(t, dtype=torch.int32), 1.0, kd,
        features=features, **kw)
    return (jcal, jfb), (pcal, pfb)


def _assert_same(j, p, label, planes=True, occupancy=True):
    (jcal, jfb), (pcal, pfb) = j, p
    if occupancy:
        np.testing.assert_array_equal(pcal.occupancy_plane.numpy(),
                                      np.asarray(jcal.occupancy_plane), err_msg=label)
    if planes:
        for i, (a, b) in enumerate(zip(jcal.payload, pcal.payload)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{label} payload {i}")
    for f in FEEDBACK:
        np.testing.assert_array_equal(getattr(pfb, f).numpy(), np.asarray(getattr(jfb, f)),
                                      err_msg=f"{label} feedback {f}")
    assert (pfb.backlog is None) == (jfb.backlog is None), label
    if jfb.backlog is not None:
        np.testing.assert_array_equal(pfb.backlog.numpy(), np.asarray(jfb.backlog),
                                      err_msg=f"{label} backlog")


# ------------------------------------------------------------- direct mode


@pytest.mark.parametrize("validate", [False, True])
@pytest.mark.parametrize("track_src", [True, False], ids=["int32-occ", "bool-occ"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_direct_mode_clean_matches_jax(seed, track_src, validate):
    """Pairwise traffic onto an empty calendar: at most one sender per
    (receiver, slot, tick), so every plane is defined and compared; the
    collision check reads zero."""
    x = _inputs(seed, o=2, track_src=track_src, fill=0.0)
    rng = np.random.default_rng(seed)
    x["dst"] = np.stack([rng.permutation(16), rng.permutation(16)]).astype(np.int32)
    x["dst"][0, :3] = [-1, 16, 99]  # out-of-range destinations drop
    j, p = _enqueue_both(_jax_state(x), _port_state(x), x, 5 + seed, seed,
                         ("latency",), slot_mode="direct", validate=validate)
    _assert_same(j, p, f"direct seed {seed}")
    assert int(p[1].collisions) == 0
    assert int(p[1].enqueued) > 0


@pytest.mark.parametrize("seed", [4, 5, 6, 7])
def test_direct_mode_validate_counts_forced_collisions(seed):
    """Fan-in onto a pre-filled calendar under ``validate``: same-tick
    duplicate targets and writes onto occupied slots are counted, with the
    first collision's (dst, slot). Which colliding write lands is
    undefined on both backends, so the payload planes are not compared;
    the bool occupancy plane is the same whichever write lands."""
    x = _inputs(seed, o=2, track_src=False, fill=0.3)
    x["dst"] = np.random.default_rng(seed).integers(0, 3, (2, 16)).astype(np.int32)
    j, p = _enqueue_both(_jax_state(x), _port_state(x), x, 9, seed,
                         ("latency", "jitter", "loss"), slot_mode="direct",
                         validate=True)
    _assert_same(j, p, f"collide seed {seed}", planes=False)
    assert int(p[1].collisions) > 0


def test_direct_mode_refuses_more_outbox_than_inbox_slots():
    x = _inputs(0, o=2, slots=1)
    with pytest.raises(ValueError, match="OUT_MSGS"):
        _enqueue_both(_jax_state(x), _port_state(x), x, 0, 0, ("latency",),
                      slot_mode="direct")


# --------------------------------------------------------------- duplicate


DUP_CASES = [
    ("latency+duplicate", ("latency", "duplicate"), True),
    ("full-shaping", jnet.FULL_SHAPING, True),
    ("full-shaping-nostack", ("latency", "duplicate", "loss", "filters"), False),
]


@pytest.mark.parametrize("label,features,stacking", DUP_CASES, ids=[c[0] for c in DUP_CASES])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_duplicate_matches_jax(label, features, stacking, seed):
    """Second copies one tick later, clipped at the horizon and counted
    as clamped there; the doubled stream through the commit."""
    for track_src in (True, False):
        x = _inputs(seed, o=3, track_src=track_src)
        _assert_same(*_enqueue_both(_jax_state(x), _port_state(x), x, 6, seed,
                                    features, stacking=stacking), label)


# --------------------------------------------------------- bandwidth_queue


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_bandwidth_queue_several_ticks_with_rate_change(seed):
    """Four ticks into one calendar with the backlog fed forward, the
    bandwidth changed under a standing backlog after tick 2, and a small
    queue bound so overflow drops too."""
    rng = np.random.default_rng(seed)
    x = _inputs(seed, o=4, w=1, horizon=32, slots=8)
    feats = ("latency", "jitter", "loss", "bandwidth_queue", "filters")
    jstate, pstate = _jax_state(x, backlog=True), _port_state(x, backlog=True)
    for tick in range(4):
        y = _inputs(1000 * seed + tick, o=4, w=1, horizon=32, slots=8)
        j, p = _enqueue_both(jstate, pstate, y, 40 + tick, seed + tick, feats,
                             bw_queue_cap=6)
        _assert_same(j, p, f"seed {seed} tick {tick}")
        (jcal, jfb), (pcal, pfb) = j, p
        egress = x["egress"].copy()
        if tick == 2:
            egress[jnet.BANDWIDTH] = rng.uniform(0.2, 4.0, 16) * jnet.MSG_BYTES * 1000.0
        jstate = (jcal, jnet.LinkState(jnp.asarray(egress), jstate[1].filters,
                                       jstate[1].region_of, backlog=jfb.backlog))
        pstate = (pcal, pnet.LinkState(torch.from_numpy(egress), pstate[1].filters,
                                       pstate[1].region_of, backlog=pfb.backlog))
        x = dict(x, egress=egress)
    assert float(pfb.backlog.max()) > 0


def test_bandwidth_queue_overflow_drops():
    x = _inputs(3, o=6, w=1, horizon=32, slots=8, bw_msgs=(0.2, 0.5))
    x["valid"][:] = True
    x["dst"] = np.tile(np.arange(16, dtype=np.int32), (6, 1))
    j, p = _enqueue_both(_jax_state(x, True), _port_state(x, True), x, 3, 3,
                         ("latency", "bandwidth_queue"), bw_queue_cap=2)
    _assert_same(j, p, "overflow")
    assert int(p[1].bw_dropped) > 0


# ------------------------------------------------------------ filter_rules


@pytest.mark.parametrize("n_rules", [1, 2, 4])
@pytest.mark.parametrize("seed", [1, 2])
def test_filter_rules_match_jax(seed, n_rules):
    x = _inputs(seed, o=3, n_rules=n_rules)
    feats = ("latency", "loss", "filter_rules")
    j, p = _enqueue_both(_jax_state(x), _port_state(x), x, 2, seed, feats)
    _assert_same(j, p, f"rules {n_rules}")
    assert int(p[1].rejected.sum()) > 0


def test_filter_rules_need_rule_planes():
    x = _inputs(1)
    with pytest.raises(ValueError, match="n_rules>0"):
        pnet.enqueue(*_port_state(x), torch.from_numpy(x["dst"]),
                     torch.from_numpy(x["payload"]), torch.from_numpy(x["valid"]),
                     torch.tensor(0, dtype=torch.int32), 1.0, (1, 2),
                     features=("latency", "filter_rules"))


# ------------------------------------------------ link state construction


@pytest.mark.parametrize("track_backlog,n_rules", [(False, 0), (True, 0), (False, 3), (True, 2)])
def test_make_link_state_matches_jax(track_backlog, n_rules):
    shape = (2.0, 0.5, 1e5, 1.0, 0.0, 3.0, 7.0)
    region = np.array([0, 1, 1, 0, 2], np.int32)
    j = jnet.make_link_state(5, 3, shape, region_of=region,
                             track_backlog=track_backlog, n_rules=n_rules)
    p = pnet.make_link_state(5, 3, shape, region_of=torch.from_numpy(region),
                             track_backlog=track_backlog, n_rules=n_rules, device="cpu")
    for f in ("egress", "filters", "region_of", "backlog", "rules"):
        a, b = getattr(j, f), getattr(p, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.numpy().dtype == np.asarray(a).dtype, f
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


def test_apply_net_updates_with_rules_matches_jax():
    rng = np.random.default_rng(8)
    n, r, k = 10, 2, 3
    base = [rng.uniform(0, 9, (7, n)).astype(np.float32),
            rng.integers(0, 3, (r, n)).astype(np.int32),
            rng.integers(0, r, n).astype(np.int32)]
    backlog = rng.uniform(0, 4, n).astype(np.float32)
    rules = rng.integers(0, n, (k, 3, n)).astype(np.int32)
    upd = [rng.uniform(0, 9, (7, n)).astype(np.float32), rng.random(n) < 0.5,
           rng.integers(0, 3, (r, n)).astype(np.int32), rng.random(n) < 0.5,
           rng.integers(0, r, n).astype(np.int32), rng.random(n) < 0.5,
           rng.integers(0, n, (k, 3, n)).astype(np.int32), rng.random(n) < 0.5]
    j = jnet.apply_net_updates(
        jnet.LinkState(*[jnp.asarray(a) for a in base], backlog=jnp.asarray(backlog),
                       rules=jnp.asarray(rules)), *[jnp.asarray(u) for u in upd])
    p = pnet.apply_net_updates(
        pnet.LinkState(*[torch.from_numpy(a) for a in base],
                       backlog=torch.from_numpy(backlog), rules=torch.from_numpy(rules)),
        *[torch.from_numpy(u) for u in upd])
    for f in ("egress", "filters", "region_of", "backlog", "rules"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    with pytest.raises(ValueError, match="n_rules=0"):
        pnet.apply_net_updates(
            pnet.LinkState(*[torch.from_numpy(a) for a in base]),
            *[torch.from_numpy(u) for u in upd])
