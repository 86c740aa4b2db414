"""network plan, torch edition: the twins of ``plans/network/sim.py``'s
``ping-pong`` and ``pingpong-sustained`` over batched ``[n_g]`` tensors.

Same state machines, same parameters, same wire format as the JAX plan;
``jnp.where`` becomes ``torch.where`` and each ``.at[].set`` chain becomes
the plane it builds. Instances pair by global sequence number
(partner = seq ^ 1); an odd count leaves a solo last instance.
"""

import torch

from testground_tpu_torch.sim.api import (
    FAILURE,
    RUNNING,
    SUCCESS,
    Outbox,
    SimTestcase,
)
from testground_tpu_torch.sim.net import SHAPING_NO_DUPLICATE

PING = 1
PONG = 2


def _i32(x):
    return x.to(torch.int32)


class PingPong(SimTestcase):
    """``pingpong.go``: shape egress latency, barrier, exchange ping/pong,
    assert the RTT lands in the shaped window, reshape to a lower latency
    mid-run and assert again."""

    STATES = ["ready", "half-done"]
    MSG_WIDTH = 2  # word0: kind, word1: round
    OUT_MSGS = 2  # slot 0: pong replies, slot 1: our own pings
    IN_MSGS = 4
    MAX_LINK_TICKS = 512  # upper bound; narrowed per run below
    SHAPING = SHAPING_NO_DUPLICATE

    @classmethod
    def specialize(cls, groups, tick_ms=1.0):
        """Size the calendar horizon to the run's shaped latencies (the
        reference plan's rule: the next power of two ≥ delay + 2, from 8)."""
        lat = 0.0
        for g in groups:
            lat = max(
                lat,
                float(g.params.get("latency_ms", 100.0)),
                float(g.params.get("latency2_ms", 10.0)),
            )
        need = max(1, round(lat / tick_ms)) + 2
        horizon = 8
        while horizon < need:
            horizon *= 2
        horizon = min(horizon, cls.MAX_LINK_TICKS)
        if horizon == cls.MAX_LINK_TICKS:
            return cls
        return type(f"{cls.__name__}_h{horizon}", (cls,), {"MAX_LINK_TICKS": horizon})

    def init(self, env):
        n_g = env.group.count

        def z(v=0, dtype=torch.int32):
            return torch.full((n_g,), v, dtype=dtype, device=env.device)

        return {
            "phase": z(),
            "start": z(),
            "start2": z(),
            "rtt1": z(-1),
            "rtt2": z(-1),
            "answered1": z(False, torch.bool),
            "got1": z(False, torch.bool),
            "answered2": z(False, torch.bool),
            "got2": z(False, torch.bool),
        }

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        p = env.group.params
        lat1 = float(p["latency_ms"]) if "latency_ms" in p else 100.0
        lat2 = float(p["latency2_ms"]) if "latency2_ms" in p else 10.0
        tol = float(p["tolerance_ms"]) if "tolerance_ms" in p else 15.0
        partner = env.global_seq ^ 1
        solo = partner >= n

        kind = inbox.payload[0]
        rnd = inbox.payload[1]
        v = inbox.valid

        def got(k, r):
            return (v & (kind == k) & (rnd == r)).any(dim=0)

        phase = state["phase"]
        ready = sync.counts[self.state_id("ready")] >= n
        half = sync.counts[self.state_id("half-done")] >= n

        p0 = phase == 0
        send_ping1 = (phase == 1) & ready
        reply1 = got(PING, 1)
        reply2 = got(PING, 2)
        gp1 = (phase == 2) & got(PONG, 1)
        gp2 = (phase == 4) & got(PONG, 2)

        answered1 = state["answered1"] | reply1 | solo
        got1 = state["got1"] | gp1 | solo
        answered2 = state["answered2"] | reply2 | solo
        got2 = state["got2"] | gp2 | solo
        rtt1 = torch.where(gp1, t - state["start"], state["rtt1"])
        rtt2 = torch.where(gp2, t - state["start2"], state["rtt2"])
        fin1 = (phase == 2) & answered1 & got1
        send_ping2 = (phase == 3) & half
        fin2 = (phase == 4) & answered2 & got2

        new_phase = torch.where(
            p0,
            1,
            torch.where(
                send_ping1,
                2,
                torch.where(
                    fin1,
                    3,
                    torch.where(send_ping2, 4, torch.where(fin2, 5, phase)),
                ),
            ),
        )

        # RTT assertions (pingpong.go:185-195 windows, in sim time)
        rtt1_ms = rtt1.to(torch.float32) * env.tick_ms
        rtt2_ms = rtt2.to(torch.float32) * env.tick_ms
        ok = solo | (
            (rtt1_ms >= 2 * lat1)
            & (rtt1_ms <= 2 * lat1 + tol)
            & (rtt2_ms >= 2 * lat2)
            & (rtt2_ms <= 2 * lat2 + tol)
        )
        status = torch.where(
            fin2, torch.where(ok, SUCCESS, FAILURE), RUNNING
        )

        send_pong = reply1 | reply2
        pong_round = torch.where(reply2, 2, 1)
        send_ping = send_ping1 | send_ping2
        ping_round = torch.where(send_ping2, 2, 1)
        ob = Outbox(
            dst=torch.stack([partner, partner]),
            # [O, W, n]: slot 0 = (PONG, pong_round), slot 1 = (PING, ping_round)
            payload=torch.stack(
                [
                    torch.stack([torch.full_like(partner, PONG), _i32(pong_round)]),
                    torch.stack([torch.full_like(partner, PING), _i32(ping_round)]),
                ]
            ),
            valid=torch.stack([send_pong, send_ping]),
        )

        shape1 = self.link_shape(latency_ms=lat1, device=env.device)
        shape2 = self.link_shape(latency_ms=lat2, device=env.device)
        return self.out(
            {
                "phase": _i32(new_phase),
                "start": torch.where(send_ping1, t, state["start"]),
                "start2": torch.where(send_ping2, t, state["start2"]),
                "rtt1": rtt1,
                "rtt2": rtt2,
                "answered1": answered1,
                "got1": got1,
                "answered2": answered2,
                "got2": got2,
            },
            status=_i32(status),
            outbox=ob,
            signals=self.signal("ready", when=p0)
            + self.signal("half-done", when=fin1),
            net_shape=torch.where(fin1[None, :], shape2[:, None], shape1[:, None]),
            net_shape_valid=p0 | fin1,
        )


class PingPongSustained(SimTestcase):
    """The headline full-path workload: paired ping-pong held for a fixed
    simulated duration through the general transport (sorted slots, src
    plane, every shaping feature but duplicate compiled in), live sync
    counters and a periodic mid-run latency reshape."""

    STATES = ["ready", "round"]
    MSG_WIDTH = 1  # word0 = kind | round << 2
    OUT_MSGS = 2  # slot 0: pong replies, slot 1: own pings
    IN_MSGS = 4
    MAX_LINK_TICKS = 8  # covers the 4ms/2ms shaped latencies at 1ms ticks
    SHAPING = SHAPING_NO_DUPLICATE

    def init(self, env):
        n_g = env.group.count
        z = torch.zeros(n_g, dtype=torch.int32, device=env.device)
        return {
            "rounds": z,
            "started": torch.zeros(n_g, dtype=torch.bool, device=env.device),
            "shape_hi": z.clone(),
        }

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        p = env.group.params
        duration = int(p["duration_ticks"]) if "duration_ticks" in p else 1000
        lat1 = float(p["latency_ms"]) if "latency_ms" in p else 4.0
        lat2 = float(p["latency2_ms"]) if "latency2_ms" in p else 2.0
        reshape_every = int(p["reshape_every"]) if "reshape_every" in p else 1000
        partner = env.global_seq ^ 1
        solo = partner >= n

        # only messages from the partner count (the provenance check the
        # src plane exists for); word0 packs kind in its low 2 bits
        from_partner = inbox.valid & (inbox.src == partner)
        kind = inbox.payload[0] & 3
        got_ping = (from_partner & (kind == PING)).any(dim=0)
        got_pong = (from_partner & (kind == PONG)).any(dim=0)

        ready = sync.counts[self.state_id("ready")] >= n
        started = state["started"] | ready
        open_ping = ready & ~state["started"]

        rounds = state["rounds"] + _i32(got_pong)
        send_ping = open_ping | got_pong
        send_pong = got_ping

        done = t >= duration
        ok = solo | (rounds > 0)
        status = torch.where(done, torch.where(ok, SUCCESS, FAILURE), RUNNING)

        word = rounds << 2
        ob = Outbox(
            dst=torch.stack([partner, partner]),
            payload=torch.stack([PONG | word, PING | word])[:, None, :],
            valid=torch.stack([send_pong & ~done, send_ping & ~done]),
        )

        # periodic reshape through the dynamic net-config path
        at_reshape = started & (torch.remainder(t, reshape_every) == 0) & (t > 0)
        shape_hi = torch.where(at_reshape, 1 - state["shape_hi"], state["shape_hi"])
        lat = torch.where(
            shape_hi == 0,
            torch.tensor(lat1, dtype=torch.float32, device=env.device),
            torch.tensor(lat2, dtype=torch.float32, device=env.device),
        )
        return self.out(
            {"rounds": rounds, "started": started, "shape_hi": shape_hi},
            status=_i32(status),
            outbox=ob,
            signals=self.signal("ready", when=t == 0)
            + self.signal("round", when=got_pong),
            net_shape=self.link_shape(latency_ms=lat, device=env.device),
            net_shape_valid=(t == 0) | at_reshape,
        )


sim_testcases = {
    "ping-pong": PingPong,
    "pingpong-sustained": PingPongSustained,
}
