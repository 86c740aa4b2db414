"""benchmarks plan, torch edition: the twins of ``plans/benchmarks/sim.py``'s
seven cases over batched ``[n_g]`` tensors.

Same state machines, same parameters, same wire format as the JAX plan;
a state leaf that is per-instance ``[k]`` there is ``[n_g, k]`` here, and
a per-instance plane the reference returns as ``[k]`` (outbox, signals,
publishes) is built instance axis last. ``collect_metrics`` takes the
final state as numpy arrays, as ``SimProgram.results()['states']`` gives
it.
"""

import numpy as np
import torch

from testground_tpu_torch.sim import prng
from testground_tpu_torch.sim.api import (
    FAILURE,
    RUNNING,
    SUCCESS,
    Outbox,
    SimTestcase,
)

PING = 1
PONG = 2

# Barrier percent sweep (``benchmarks.go:109-118``: 0.2 → 1.0 step 0.2).
BARRIER_PCTS = (0.2, 0.4, 0.6, 0.8, 1.0)

# Payload sizes 64 B → 4 KiB by doubling (``benchmarks.go:184``).
SUBTREE_SIZES = (64, 128, 256, 512, 1024, 2048, 4096)


def _i32(x):
    return x.to(torch.int32)


def _param(env, name, default, conv=int):
    return conv(env.string_param(name)) if name in env.group.params else default


def _full(env, value, dtype=torch.int32, shape=()):
    return torch.full((env.group_lanes, *shape), value, dtype=dtype, device=env.device)


def _status(done, ok=None):
    """SUCCESS where ``done`` (and ``ok``), FAILURE where done and not ok."""
    if ok is None:
        return _i32(torch.where(done, SUCCESS, RUNNING))
    return _i32(torch.where(done, torch.where(ok, SUCCESS, FAILURE), RUNNING))


class Barrier(SimTestcase):
    """Partial-barrier timing sweep (``benchmarks.go:88-145``): per
    iteration and percent p, everyone signals a full-count "ready" gate,
    then a "test" state released at ⌊N·p⌋ signallers; the ticks to release
    are ``barrier_time_{p}_percent``. Counters are monotone, so iteration i
    waits for cumulative targets, and the phase index is the state index."""

    STATES = [
        s
        for p in BARRIER_PCTS
        for s in (f"ready_{int(p * 100)}", f"test_{int(p * 100)}")
    ]
    OUT_MSGS = 1
    IN_MSGS = 1
    MSG_WIDTH = 1
    MAX_LINK_TICKS = 4

    def init(self, env):
        return {
            "iter": _full(env, 1),
            "phase": _full(env, 0),
            "start": _full(env, 0),
            "sums": _full(env, 0, shape=(len(BARRIER_PCTS),)),
        }

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        n_phases = len(self.STATES)
        iters = _param(env, "barrier_iterations", 10)
        dev = env.device
        # testInstanceNum = max(1, floor(N * percent)) — benchmarks.go:126-130
        test_counts = self.device_constant(
            tuple(max(1, int(n * p)) for p in BARRIER_PCTS), torch.int32, dev
        )
        phase, it = state["phase"], state["iter"]
        pct_idx = torch.div(phase, 2, rounding_mode="floor")
        is_test = torch.remainder(phase, 2) == 1
        target = torch.where(is_test, (it - 1) * n + test_counts[pct_idx], it * n)
        released = sync.counts[phase] >= target

        elapsed = t - state["start"]
        pct_ax = torch.arange(len(BARRIER_PCTS), dtype=torch.int32, device=dev)
        sums = state["sums"] + (pct_ax[None, :] == pct_idx[:, None]) * (
            elapsed * (released & is_test)
        )[:, None]

        nphase_raw = phase + 1
        wrap = nphase_raw >= n_phases
        nphase = torch.where(wrap, 0, nphase_raw)
        new_phase = torch.where(released, nphase, phase)
        new_iter = it + (released & wrap)
        done = new_iter > iters
        # entering a test phase starts its timer (benchmarks.go:134)
        start = torch.where(released & ~is_test, t, state["start"])

        emit = (t == 0) | (released & ~done)
        sig_phase = torch.where(t == 0, 0, nphase)
        phase_ax = torch.arange(n_phases, dtype=torch.int32, device=dev)
        signals = (phase_ax[:, None] == sig_phase[None, :]).to(torch.int32) * emit[None, :]
        return self.out(
            {"iter": new_iter, "phase": new_phase, "start": start, "sums": sums},
            status=_status(done),
            signals=signals,
        )

    def collect_metrics(self, group, final_state, status):
        iters = int(group.params.get("barrier_iterations", 10))
        return {
            f"barrier_time_{int(p * 100)}_percent": final_state["sums"][:, i]
            / max(iters, 1)
            for i, p in enumerate(BARRIER_PCTS)
        }


class NetInit(SimTestcase):
    """time-to-network-init (``benchmarks.go:29-48``): every instance
    signals on its first step; the metric is the full-count barrier's
    round trip."""

    STATES = ["network-initialized"]
    OUT_MSGS = 1
    IN_MSGS = 1
    MSG_WIDTH = 1
    MAX_LINK_TICKS = 2
    TRACK_SRC = False
    SHAPING = ("latency",)

    def init(self, env):
        return {"init_at": _full(env, -1)}

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        ready = sync.counts[self.state_id("network-initialized")] >= n
        init_at = torch.where((state["init_at"] < 0) & ready, t, state["init_at"])
        return self.out(
            {"init_at": init_at},
            status=_status(ready.expand_as(init_at)),
            signals=self.signal("network-initialized", when=t == 0),
        )

    def collect_metrics(self, group, final_state, status):
        return {"time_to_network_init_ticks": final_state["init_at"]}


class NetLinkShape(SimTestcase):
    """time-to-shape-network (``benchmarks.go:50-86``) plus a check that
    the shape took hold: each instance emits the shape and a
    "network-configured" signal on tick 0, then pings its partner once
    the barrier releases and asserts the one-way delay equals the shaped
    latency in ticks (FAILURE on mismatch)."""

    STATES = ["network-configured"]
    OUT_MSGS = 1
    IN_MSGS = 1
    MSG_WIDTH = 1
    MAX_LINK_TICKS = 256
    TRACK_SRC = False
    SLOT_MODE = "direct"
    SHAPING = ("latency",)

    def init(self, env):
        return {
            "cfg_at": _full(env, -1),
            "sent_at": _full(env, -1),
            "got_at": _full(env, -1),
        }

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        lat = _param(env, "latency_ms", 250.0, float)
        lat_ticks = min(env.ms_to_ticks(lat), cls.MAX_LINK_TICKS - 1)
        partner = env.global_seq ^ 1
        has_partner = partner < n

        configured = sync.counts[self.state_id("network-configured")] >= n
        just_cfg = (state["cfg_at"] < 0) & configured
        cfg_at = torch.where(just_cfg, t, state["cfg_at"])

        send = just_cfg & has_partner
        sent_at = torch.where(send, t, state["sent_at"])
        got = inbox.valid.any(dim=0)
        got_at = torch.where((state["got_at"] < 0) & got, t, state["got_at"])

        delay = got_at - sent_at
        verified = (got_at >= 0) & (delay == lat_ticks)
        wrong = (got_at >= 0) & (delay != lat_ticks)
        ok = torch.where(has_partner, verified, cfg_at >= 0)
        status = torch.where(wrong, FAILURE, torch.where(ok, SUCCESS, RUNNING))
        return self.out(
            {"cfg_at": cfg_at, "sent_at": sent_at, "got_at": got_at},
            status=_i32(status),
            outbox=Outbox.single(
                partner, [PING], send, cls.OUT_MSGS, cls.MSG_WIDTH
            ),
            signals=self.signal("network-configured", when=t == 0),
            net_shape=self.link_shape(latency_ms=lat, device=env.device)[:, None],
            net_shape_valid=t == 0,
        )

    def collect_metrics(self, group, final_state, status):
        got = np.asarray(final_state["got_at"])
        sent = np.asarray(final_state["sent_at"])
        return {
            "time_to_shape_network_ticks": final_state["cfg_at"],
            "shaped_latency_ticks": np.where(
                (got >= 0) & (sent >= 0), got - sent, np.nan
            ),
        }


class Subtree(SimTestcase):
    """Pub/sub subtree benchmark (``benchmarks.go:147-276``): the instance
    ranked first on "elected" publishes ``iterations`` entries per size
    series (payload ``(size ^ iteration, iteration)``), one a tick, then
    signals "handoff"; subscribers drain each series in order at SUB_K a
    tick, FAILURE on any mismatch, and all end on a full-count "end"
    barrier."""

    STATES = ["elected", "handoff", "end"]
    TOPICS = [f"subtree_{s}" for s in SUBTREE_SIZES]
    OUT_MSGS = 1
    IN_MSGS = 1
    MSG_WIDTH = 1
    PUB_WIDTH = 2
    SUB_K = 8
    TOPIC_CAP = 128
    MAX_LINK_TICKS = 2
    TRACK_SRC = False
    SHAPING = ("latency",)

    def _iters(self, env) -> int:
        iters = _param(env, "subtree_iterations", 64)
        if iters > type(self).TOPIC_CAP:
            raise ValueError(
                f"subtree_iterations={iters} exceeds TOPIC_CAP="
                f"{type(self).TOPIC_CAP}; raise the cap or lower iterations"
            )
        return iters

    def init(self, env):
        k = len(SUBTREE_SIZES)
        return {
            "pub_idx": _full(env, 0),
            "got": _full(env, 0, shape=(k,)),
            "bad": _full(env, False, torch.bool),
            "handoff_at": _full(env, -1),
            "done_at": _full(env, -1, shape=(k,)),
            "pub_done_at": _full(env, -1, shape=(k,)),
            "sig_handoff": _full(env, False, torch.bool),
            "sig_end": _full(env, False, torch.bool),
        }

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        iters = self._iters(env)
        k = len(SUBTREE_SIZES)
        total = k * iters
        dev = env.device
        lane = torch.arange(env.group_lanes, device=dev)
        sizes = self.device_constant(SUBTREE_SIZES, torch.int32, dev)
        series_ax = torch.arange(k, dtype=torch.int32, device=dev)[None, :]

        rank = sync.last_seq[self.state_id("elected")]
        is_pub = rank == 1
        is_sub = rank > 1

        # ---------------------------------------------------- publisher path
        pub_idx0 = state["pub_idx"]
        can_pub = is_pub & (pub_idx0 < total)
        ser = torch.div(pub_idx0, iters, rounding_mode="floor").clamp_max(k - 1)
        itr = torch.remainder(pub_idx0, iters) + 1
        checksum = sizes[ser] ^ itr
        pub_row = series_ax == ser[:, None]  # [n_g, k]
        pub_valid = pub_row & can_pub[:, None]
        pub_payload = torch.where(
            pub_row[:, :, None], torch.stack([checksum, itr], dim=-1)[:, None, :], 0
        )  # [n_g, k, PW]
        pub_idx = pub_idx0 + can_pub
        pub_done_at = torch.where(
            pub_valid & (itr == iters)[:, None], t, state["pub_done_at"]
        )
        sig_handoff = is_pub & (pub_idx >= total) & ~state["sig_handoff"]
        # the publisher's SignalAndWait(end) — one tick after handoff
        sig_end_pub = is_pub & state["sig_handoff"] & ~state["sig_end"]

        # --------------------------------------------------- subscriber path
        handoff_ok = sync.counts[self.state_id("handoff")] >= 1
        handoff_at = torch.where(
            (state["handoff_at"] < 0) & handoff_ok & is_sub, t, state["handoff_at"]
        )
        done_series = state["got"] >= iters
        # series are consumed in order; the first unfinished one
        rser = done_series.sum(dim=1).clamp_max(k - 1)  # int64, an index
        consuming = is_sub & handoff_ok & ~done_series.all(dim=1)
        win_pay = sync.sub_payload[rser, :, :, lane]  # [n_g, K, PW]
        win_val = sync.sub_valid[rser, :, lane]  # [n_g, K]
        got_cur = state["got"][lane, rser]
        k_idx = torch.arange(cls.SUB_K, dtype=torch.int32, device=dev)[None, :]
        take = win_val & (k_idx < (iters - got_cur)[:, None]) & consuming[:, None]
        exp_itr = got_cur[:, None] + k_idx + 1
        exp_sum = sizes[rser][:, None] ^ exp_itr
        mismatch = take & (
            (win_pay[:, :, 0] != exp_sum) | (win_pay[:, :, 1] != exp_itr)
        )
        bad = state["bad"] | mismatch.any(dim=1)
        ncons = take.sum(dim=1, dtype=torch.int32)
        cur = series_ax == rser[:, None]  # [n_g, k]
        got = state["got"] + cur * ncons[:, None]
        newly_done = consuming & (got[lane, rser] >= iters)
        done_at = torch.where(cur & newly_done[:, None], t, state["done_at"])
        sub_consume = cur * ncons[:, None]
        sig_end_sub = is_sub & (got >= iters).all(dim=1) & ~state["sig_end"]

        sig_end = sig_end_pub | sig_end_sub
        end_ok = sync.counts[self.state_id("end")] >= n
        status = torch.where(bad, FAILURE, torch.where(end_ok, SUCCESS, RUNNING))
        return self.out(
            {
                "pub_idx": pub_idx,
                "got": got,
                "bad": bad,
                "handoff_at": handoff_at,
                "done_at": done_at,
                "pub_done_at": pub_done_at,
                "sig_handoff": state["sig_handoff"] | sig_handoff,
                "sig_end": state["sig_end"] | sig_end,
            },
            status=_i32(status),
            signals=self.signal("elected", when=t == 0)
            + self.signal("handoff", when=sig_handoff)
            + self.signal("end", when=sig_end),
            pub_payload=pub_payload.permute(1, 2, 0),
            pub_valid=pub_valid.T,
            sub_consume=sub_consume.T,
        )

    def collect_metrics(self, group, final_state, status):
        iters = int(group.params.get("subtree_iterations", 64))
        done = np.asarray(final_state["done_at"], np.float64)  # [count, k]
        pub_done = np.asarray(final_state["pub_done_at"], np.float64)
        handoff = np.asarray(final_state["handoff_at"], np.float64)
        # per-series elapsed: the first series counts from handoff, later
        # ones from the previous series' completion
        prev = np.concatenate([handoff[:, None], done[:, :-1]], axis=1)
        recv = np.where((done >= 0) & (prev >= 0), done - prev, np.nan)
        pub_prev = np.concatenate(
            [np.zeros_like(pub_done[:, :1]), pub_done[:, :-1]], axis=1
        )
        pub = np.where(pub_done >= 0, pub_done - pub_prev, np.nan)
        out = {}
        for i, size in enumerate(SUBTREE_SIZES):
            out[f"subtree_time_{size}_bytes_receive_ticks"] = recv[:, i] / max(iters, 1)
            out[f"subtree_time_{size}_bytes_publish_ticks"] = pub[:, i] / max(iters, 1)
        return out


class PingPongFlood(SimTestcase):
    """Continuous paired ping-pong under link shaping for a fixed simulated
    duration, with the fast-path knobs: pairwise traffic has one sender per
    receiver per tick, so direct slots, no provenance plane, and a horizon
    that only covers the shaped latency."""

    MSG_WIDTH = 1  # word0 packs kind (low 2 bits) | round << 2
    OUT_MSGS = 1
    IN_MSGS = 1
    MAX_LINK_TICKS = 8
    TRACK_SRC = False
    SLOT_MODE = "direct"
    SHAPING = ("latency",)

    def init(self, env):
        return {"rounds": _full(env, 0)}

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        duration = _param(env, "duration_ticks", 1000)
        lat = _param(env, "latency_ms", 4.0, float)
        partner = env.global_seq ^ 1

        kind = inbox.payload[0] & 3
        got_ping = (inbox.valid & (kind == PING)).any(dim=0)
        got_pong = (inbox.valid & (kind == PONG)).any(dim=0)

        rounds = state["rounds"] + got_pong
        # t==0: open with a ping; then reply pong to pings, new ping on pongs
        send = (t == 0) | got_ping | got_pong
        out_kind = _i32(torch.where(got_ping, PONG, PING))

        done = t >= duration
        return self.out(
            {"rounds": rounds},
            status=_status(done.expand_as(rounds)),
            outbox=Outbox.single(
                partner,
                (out_kind | (rounds << 2))[None, :],
                send & ~done,
                cls.OUT_MSGS,
                cls.MSG_WIDTH,
            ),
            net_shape=self.link_shape(latency_ms=lat, device=env.device)[:, None],
            net_shape_valid=t == 0,
        )

    def collect_metrics(self, group, final_state, status):
        return {"flood.rounds": final_state["rounds"]}


class Storm(SimTestcase):
    """Gossip-storm flood over a random connection graph
    (``plans/benchmarks/storm.go:66-120``): each instance draws
    ``conn_outgoing`` random peers and start delays from its own key at
    init, then, once the dials barrier releases, pushes one 4 KiB chunk a
    tick down every open connection until ``data_size_kb`` is written.
    Fan-in is Poisson(K), so the general sorted slot path carries it; fan-in
    past IN_MSGS in one tick drops, and counts as dropped."""

    STATES = ["listening", "dials-done", "done-writing"]
    MSG_WIDTH = 1  # word0 packs kind (low 2 bits) | chunk seq << 2
    OUT_MSGS = 8  # upper bound on conn_outgoing (narrowed per run below)
    IN_MSGS = 16  # covers the Poisson(K) per-tick fan-in tail
    MAX_LINK_TICKS = 8
    TRACK_SRC = False
    SHAPING = ("latency",)
    # one uniform latency, never reshaped: a bucket fills from one send tick
    CROSS_TICK_STACKING = False
    CHUNK_BYTES = 4096  # storm.go buffersize

    @classmethod
    def specialize(cls, groups, tick_ms=1.0):
        """Narrow OUT_MSGS to the run's largest ``conn_outgoing``; IN_MSGS
        stays at the static bound (in-degree is Poisson over the run)."""
        k = max(
            (int(g.params.get("conn_outgoing", 5)) for g in groups),
            default=5,
        )
        k = max(1, min(k, cls.OUT_MSGS))
        if k == cls.OUT_MSGS:
            return cls
        return type(f"{cls.__name__}_k{k}", (cls,), {"OUT_MSGS": k})

    def init(self, env):
        cls = type(self)
        n = env.test_instance_count
        keys = prng.split(env.key)  # [n_g, 2, 2]: k_targets, k_delay
        # conn_outgoing random peers, self-index skipped by shifting
        # torch.clamp, not Python max, on a count that is a 0-d tensor
        # (shape bucketing): max() would read it on the host
        hi = torch.clamp(n - 1, min=1) if isinstance(n, torch.Tensor) else max(n - 1, 1)
        targets = prng.randint(keys[:, 0], (cls.OUT_MSGS,), 0, hi)
        targets = targets + (targets >= env.global_seq[:, None])
        delay_max = _param(env, "conn_delay_ticks", 32)
        delays = prng.randint(keys[:, 1], (cls.OUT_MSGS,), 0, max(delay_max, 1))
        return {
            "targets": _i32(targets),
            "delays": delays,
            "sent_chunks": _full(env, 0, shape=(cls.OUT_MSGS,)),
            "bytes_read": _full(env, 0),
            "start": _full(env, -1),
            "dialed": _full(env, False, torch.bool),
            "written": _full(env, False, torch.bool),
        }

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        outgoing = min(_param(env, "conn_outgoing", 5), cls.OUT_MSGS)
        chunks = _param(env, "data_size_kb", 128) * 1024 // cls.CHUNK_BYTES

        conn = torch.arange(cls.OUT_MSGS, device=env.device)
        live_conn = (conn < outgoing)[None, :]  # [1, O]

        listening = sync.counts[self.state_id("listening")] >= n
        start = torch.where((state["start"] < 0) & listening, t, state["start"])
        started = start >= 0

        # connection c opens at start + delays[c]; writes begin only after
        # the global dials barrier (storm.go's SignalAndWait gate)
        due = t >= start[:, None] + state["delays"]  # [n_g, O]
        opened = started[:, None] & due & live_conn
        all_dialed = started & (due | ~live_conn).all(dim=1)
        sig_dialed = all_dialed & ~state["dialed"]
        writes_open = sync.counts[self.state_id("dials-done")] >= n
        sending = opened & writes_open & (state["sent_chunks"] < chunks)
        sent_chunks = state["sent_chunks"] + sending

        all_written = started & ((sent_chunks >= chunks) | ~live_conn).all(dim=1)
        sig_written = all_written & ~state["written"]

        kind = inbox.payload[0] & 3
        got = inbox.valid & (kind == PING)  # chunk messages reuse kind=1
        bytes_read = state["bytes_read"] + cls.CHUNK_BYTES * got.sum(
            dim=0, dtype=torch.int32
        )

        done = sync.counts[self.state_id("done-writing")] >= n
        ob = Outbox(
            dst=state["targets"].T,
            payload=(PING | (state["sent_chunks"] << 2)).T[:, None, :],
            valid=sending.T,
        )
        return self.out(
            {
                "targets": state["targets"],
                "delays": state["delays"],
                "sent_chunks": sent_chunks,
                "bytes_read": bytes_read,
                "start": start,
                "dialed": state["dialed"] | sig_dialed,
                "written": state["written"] | sig_written,
            },
            status=_status(done.expand_as(start)),
            outbox=ob,
            signals=self.signal("listening", when=t == 0)
            + self.signal("dials-done", when=sig_dialed)
            + self.signal("done-writing", when=sig_written),
        )

    def collect_metrics(self, group, final_state, status):
        cls = type(self)
        return {
            "storm.bytes_sent": cls.CHUNK_BYTES
            * np.asarray(final_state["sent_chunks"]).sum(axis=-1),
            "storm.bytes_read": final_state["bytes_read"],
        }


class Startup(SimTestcase):
    """time-to-start analog (``benchmarks.go:23``): succeed on the first
    tick."""

    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=SUCCESS)


sim_testcases = {
    "barrier": Barrier,
    "netinit": NetInit,
    "netlinkshape": NetLinkShape,
    "pingpong-flood": PingPongFlood,
    "startup": Startup,
    "storm": Storm,
    "subtree": Subtree,
}
