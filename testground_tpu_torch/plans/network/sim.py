"""network plan, torch edition: the twins of ``plans/network/sim.py``'s six
cases (``ping-pong``, ``pingpong-sustained``, ``traffic-allowed``,
``traffic-blocked``, ``traffic-shaped``, ``traffic-ruled``) over batched
``[n_g]`` tensors.

Same state machines, same parameters, same wire format as the JAX plan;
``jnp.where`` becomes ``torch.where`` and each ``.at[].set`` chain becomes
the plane it builds. Instances pair by global sequence number
(partner = seq ^ 1) or chain to their ring successor; an odd count
leaves a solo last instance.
"""

import math

import numpy as np
import torch

from testground_tpu_torch.sim.api import (
    FAILURE,
    FILTER_ACCEPT,
    FILTER_DROP,
    FILTER_REJECT,
    RUNNING,
    SUCCESS,
    Outbox,
    SimTestcase,
)
from testground_tpu_torch.sim.net import MSG_BYTES, SHAPING_NO_DUPLICATE

PING = 1
PONG = 2


def _i32(x):
    return x.to(torch.int32)


def _zeros(env, value=0):
    return torch.full((env.group_lanes,), value, dtype=torch.int32, device=env.device)


def _judged(judge, ok):
    return _i32(torch.where(judge, torch.where(ok, SUCCESS, FAILURE), RUNNING))


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
        n_g = env.group_lanes

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

    def collect_metrics(self, group, final_state, status):
        return {
            "pingpong.rtt1_ticks": final_state["rtt1"],
            "pingpong.rtt2_ticks": final_state["rtt2"],
        }


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
        n_g = env.group_lanes
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
        lat_c = self.device_constant((lat1, lat2), torch.float32, env.device)
        lat = torch.where(shape_hi == 0, lat_c[0], lat_c[1])
        return self.out(
            {"rounds": rounds, "started": started, "shape_hi": shape_hi},
            status=_i32(status),
            outbox=ob,
            signals=self.signal("ready", when=t == 0)
            + self.signal("round", when=got_pong),
            net_shape=self.link_shape(latency_ms=lat, device=env.device),
            net_shape_valid=(t == 0) | at_reshape,
        )

    def collect_metrics(self, group, final_state, status):
        return {"sustained.rounds": final_state["rounds"]}


class _Traffic(SimTestcase):
    """Ring traffic under an Accept (allowed) or Drop (blocked) filter
    (``traffic.go:16-46``): install the filter and signal, send once to
    the ring successor after the barrier, and judge after ``wait_ticks``
    whether traffic flowed."""

    STATES = ["net-ready"]
    BLOCKED = False
    MSG_WIDTH = 2
    OUT_MSGS = 1
    IN_MSGS = 4

    def init(self, env):
        return {"phase": _zeros(env), "deadline": _zeros(env), "received": _zeros(env)}

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        p = env.group.params
        wait = int(p["wait_ticks"]) if "wait_ticks" in p else 50
        succ = torch.remainder(env.global_seq + 1, n)

        phase = state["phase"]
        ready = sync.counts[self.state_id("net-ready")] >= n
        p0 = phase == 0
        send = (phase == 1) & ready

        received = state["received"] + inbox.count
        deadline = torch.where(send, t + wait, state["deadline"])
        judge = (phase == 2) & (t >= deadline)
        ok = (received > 0) != cls.BLOCKED

        action = FILTER_DROP if cls.BLOCKED else FILTER_ACCEPT
        n_groups = len(env.groups)
        return self.out(
            {
                "phase": _i32(torch.where(p0, 1, torch.where(send, 2, phase))),
                "deadline": deadline,
                "received": received,
            },
            status=_judged(judge, ok),
            outbox=Outbox.single(succ, [1, 0], send, cls.OUT_MSGS, cls.MSG_WIDTH),
            signals=self.signal("net-ready", when=p0),
            net_filters=torch.full(
                (n_groups, 1), action, dtype=torch.int32, device=env.device
            ),
            net_filters_valid=p0,
        )

    def collect_metrics(self, group, final_state, status):
        return {"traffic.received": final_state["received"]}


class TrafficAllowed(_Traffic):
    BLOCKED = False


class TrafficBlocked(_Traffic):
    BLOCKED = True


class TrafficRuled(SimTestcase):
    """Ring traffic cut mid-run by a per-instance range rule (the
    "filter_rules" model, ``pkg/sidecar/link.go:187-217``): at ``cut_tick``
    each instance installs a REJECT rule over exactly its successor, and
    asserts the one-tick turnaround, the REJECT feedback and untouched
    traffic before the cut."""

    FILTER_RULES = 2
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 8
    SHAPING = ("latency", "filter_rules")
    DEFAULT_LINK = (1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def init(self, env):
        return {
            "received": _zeros(env),
            "last_arrival": _zeros(env, -1),
            "rejected": _zeros(env),
        }

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        p = env.group.params
        cut = int(p["cut_tick"]) if "cut_tick" in p else 8
        stop = int(p["stop_tick"]) if "stop_tick" in p else 24
        succ = torch.remainder(env.global_seq + 1, n)

        count = inbox.count
        received = state["received"] + count
        last = torch.where(count > 0, t, state["last_arrival"])
        rejected = state["rejected"] + sync.rejected

        # the rule lands at cut's end: sends 0..cut deliver (the last at
        # cut + delay) and every later send REJECTs back
        delay = math.ceil(self.DEFAULT_LINK[0] / env.tick_ms)
        judge = t >= stop + delay + 4
        ok = (
            (received == cut + 1)
            & (last == cut + delay)
            & (rejected == stop - (cut + 1))
        )
        return self.out(
            {"received": received, "last_arrival": last, "rejected": rejected},
            status=_judged(judge, ok),
            outbox=Outbox.single(succ, [1], t < stop, 1, 1),
            net_rules=self.filter_rules((succ, succ + 1, FILTER_REJECT)),
            net_rules_valid=t == cut,
        )

    def collect_metrics(self, group, final_state, status):
        return {
            "traffic.received": final_state["received"],
            "traffic.rejected": final_state["rejected"],
        }


class TrafficShaped(SimTestcase):
    """Ring burst through an HTB-shaped link ("bandwidth_queue"): each
    instance sends ``burst`` messages in one tick at ``rate`` msgs/tick,
    and the receiver asserts conservation (every message arrives) and
    pacing (the last arrives exactly at send + 1 + floor((burst-1)/rate))."""

    STATES = ["net-ready"]
    MSG_WIDTH = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 64  # narrowed by specialize below
    SHAPING = ("latency", "bandwidth_queue")

    @classmethod
    def specialize(cls, groups, tick_ms=1.0):
        bursts = {int(g.params.get("burst", 8)) for g in groups} or {8}
        rates = {float(g.params.get("rate", 2.0)) for g in groups} or {2.0}
        if len(bursts) > 1 or len(rates) > 1:
            raise ValueError(
                "traffic-shaped needs identical burst/rate across groups "
                f"(got bursts={sorted(bursts)}, rates={sorted(rates)})"
            )
        burst, rate = bursts.pop(), rates.pop()
        if rate <= 0:
            raise ValueError(
                f"traffic-shaped rate must be > 0 msgs/tick (got {rate}); "
                "rate 0 means an unshaped link — use traffic-allowed"
            )
        # bandwidth bytes/s for `rate` msgs/tick (MSG_BYTES per message)
        bw = rate * MSG_BYTES * 1000.0 / tick_ms
        horizon = int(burst / rate) + 8  # last dt + latency + slack

        class Specialized(cls):
            OUT_MSGS = burst
            # worst case the whole burst lands in one tick (rate ≥ burst)
            IN_MSGS = burst
            MAX_LINK_TICKS = horizon
            DEFAULT_LINK = (1.0, 0.0, bw, 0.0, 0.0, 0.0, 0.0)

        return Specialized

    def init(self, env):
        return {
            "phase": _zeros(env),
            "sent_at": _zeros(env, -1),
            "received": _zeros(env),
            "last_arrival": _zeros(env, -1),
        }

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        p = env.group.params
        burst = int(p["burst"]) if "burst" in p else 8
        rate = float(p["rate"]) if "rate" in p else 2.0
        succ = torch.remainder(env.global_seq + 1, n)

        phase = state["phase"]
        ready = sync.counts[self.state_id("net-ready")] >= n
        p0 = phase == 0
        send = (phase == 1) & ready

        received = state["received"] + inbox.count
        last_arrival = torch.where(inbox.count > 0, t, state["last_arrival"])
        sent_at = torch.where(send, t, state["sent_at"])

        # exact HTB schedule: burst message j departs floor(j/rate) ticks
        # late and rides the 1-tick latency floor (the reference floors
        # the float32 value of the Python expression)
        lag = int(np.floor(np.float32((burst - 1) / rate + 1e-4)))
        expected_last = sent_at + 1 + lag
        judge = (phase == 2) & (t > expected_last + 4)
        ok = (received == burst) & (last_arrival == expected_last)
        return self.out(
            {
                "phase": _i32(torch.where(p0, 1, torch.where(send, 2, phase))),
                "sent_at": sent_at,
                "received": received,
                "last_arrival": last_arrival,
            },
            status=_judged(judge, ok),
            outbox=Outbox(
                dst=succ[None, :].expand(burst, -1),
                payload=torch.ones((burst, 1, 1), dtype=torch.int32, device=env.device),
                valid=send[None, :].expand(burst, -1),
            ),
            signals=self.signal("net-ready", when=p0),
        )

    def collect_metrics(self, group, final_state, status):
        return {
            "traffic.received": final_state["received"],
            "traffic.last_arrival_tick": final_state["last_arrival"],
        }


sim_testcases = {
    "ping-pong": PingPong,
    "pingpong-sustained": PingPongSustained,
    "traffic-allowed": TrafficAllowed,
    "traffic-blocked": TrafficBlocked,
    "traffic-shaped": TrafficShaped,
    "traffic-ruled": TrafficRuled,
}
