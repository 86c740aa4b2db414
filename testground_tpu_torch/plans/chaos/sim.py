"""chaos plan, torch edition: the twin of ``plans/chaos/sim.py``, the fault
plane's end-to-end exercise.

The composition declares the chaos (crashes, restarts, link flaps, a
partition); the plan is a cooperative state machine that survives it:

1. everyone signals ``start`` and waits at a barrier written against the
   live membership (``counts >= Σ sync.live``), so a crash mid-barrier
   degrades the target and the survivors proceed; a ``slow_count`` prefix
   holds its signal until ``slow_tick``;
2. a pipelined probe sweep (one probe a tick at peer ``(me + 1 + k) mod
   n``) sends traffic through the flap and partition windows;
3. restarted instances come back through ``init`` with their sync history
   (``last_seq``), so nobody signals twice;
4. from ``heal_tick`` every instance probes its partner ``(me + n//2) mod
   n`` across the old partition, resending every few ticks; SUCCESS needs
   a heal reply received AND a heal probe answered, and no handshake by
   ``deadline`` is a FAILURE.
"""

import torch

from testground_tpu_torch.sim.api import (
    FAILURE,
    RUNNING,
    SUCCESS,
    Outbox,
    SimTestcase,
)

PROBE = 1
REPLY = 2

# phases
P_START = 0  # signal "start" (slow instances hold until slow_tick)
P_WAIT = 1  # live-degraded barrier
P_PROBE = 2  # pipelined probe sweep
P_HEAL = 3  # cross-partition heal handshake
P_DONE = 4

_HEAL_EVERY = 4  # heal-probe resend cadence in ticks


def _first(mask):
    """[SLOTS, n] bool → [1, n] index of the first True slot (0 if none)."""
    return torch.argmax(mask.to(torch.int32), dim=0, keepdim=True)


class ChaosBarrier(SimTestcase):
    STATES = ["start"]
    MSG_WIDTH = 2  # word0: kind, word1: probe id (sweep k, or n = heal)
    OUT_MSGS = 2  # slot 0: reply, slot 1: own probe
    IN_MSGS = 8
    MAX_LINK_TICKS = 8
    SHAPING = ("latency",)

    def init(self, env):
        def z(dtype=torch.int32):
            return torch.zeros(env.group_lanes, dtype=dtype, device=env.device)

        return {
            "phase": z(),
            "k": z(),  # next sweep probe index
            "replies": z(),  # sweep replies received (metric only)
            "heal_got": z(torch.bool),
            # answered the prober whose partner is me: success needs both
            # sides of the handshake
            "heal_answered": z(torch.bool),
        }

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        params = env.group.params

        def p(name, default):
            return int(params[name]) if name in params else default

        slow_count = p("slow_count", 2)
        slow_tick = p("slow_tick", 30)
        heal_tick = p("heal_tick", 44)
        deadline = p("deadline", 120)
        phase = state["phase"]
        me = env.global_seq

        # --- serve replies in every phase: answer the first probe in the
        # inbox, echoing its id back to its sender
        kind = inbox.word(0)
        pid = inbox.word(1)
        is_probe = inbox.valid & (kind == PROBE)
        got_reply = inbox.valid & (kind == REPLY)
        slot = _first(is_probe)
        send_reply = is_probe.any(dim=0)
        reply_to = inbox.src.gather(0, slot)[0]
        reply_id = pid.gather(0, slot)[0]

        # --- START: signal once (a restarted instance re-enters here with
        # its sync history: last_seq > 0 means its signal still stands)
        ready = (me >= slow_count) | (t >= slow_tick)
        already = sync.last_seq[self.state_id("start")] > 0
        do_signal = (phase == P_START) & ready & ~already
        leave_start = (phase == P_START) & ready

        # --- WAIT: the live-degraded barrier
        counts = sync.counts[self.state_id("start")]
        live_total = sync.live.sum()
        barrier_open = (counts > 0) & (counts >= live_total)
        leave_wait = (phase == P_WAIT) & barrier_open

        # --- PROBE: pipelined sweep, one probe a tick
        k = state["k"]
        rounds = n - 1
        probing = (phase == P_PROBE) & (k < rounds)
        sweep_target = torch.remainder(me + 1 + k, n)
        k_next = torch.where(probing, k + 1, k)
        leave_probe = (phase == P_PROBE) & (k >= rounds)
        replies = state["replies"] + got_reply.sum(dim=0, dtype=torch.int32)

        # --- HEAL: from heal_tick, probe the partner across the old
        # partition until answered, in global lockstep
        partner = torch.remainder(me + n // 2, n)
        heal_got = state["heal_got"] | (got_reply & (pid == n)).any(dim=0)
        heal_answered = state["heal_answered"] | (send_reply & (reply_id == n))
        heal_probe = (
            (phase == P_HEAL)
            & ~heal_got
            & (t >= heal_tick)
            & (torch.remainder(t - heal_tick, _HEAL_EVERY) == 0)
        )
        done_heal = heal_got & heal_answered
        finish = (phase == P_HEAL) & done_heal
        timed_out = (phase == P_HEAL) & ~done_heal & (t >= deadline)

        new_phase = torch.where(
            leave_start,
            P_WAIT,
            torch.where(
                leave_wait,
                P_PROBE,
                torch.where(leave_probe, P_HEAL, torch.where(finish, P_DONE, phase)),
            ),
        ).to(torch.int32)
        status = torch.where(
            timed_out, FAILURE, torch.where(finish, SUCCESS, RUNNING)
        ).to(torch.int32)

        send_probe = probing | heal_probe
        probe_dst = torch.where(heal_probe, partner, sweep_target)
        probe_id = torch.where(heal_probe, n, k)
        zeros = torch.zeros_like(reply_to)
        ob = Outbox(
            dst=torch.stack([reply_to, probe_dst]).to(torch.int32),
            payload=torch.stack([
                torch.stack([zeros + REPLY, reply_id]),
                torch.stack([zeros + PROBE, probe_id]),
            ]).to(torch.int32),
            valid=torch.stack([send_reply, send_probe]),
        )
        return self.out(
            {
                "phase": new_phase,
                "k": k_next,
                "replies": replies,
                "heal_got": heal_got,
                "heal_answered": heal_answered,
            },
            status=status,
            outbox=ob,
            signals=self.signal("start", when=do_signal),
        )

    def collect_metrics(self, group, final_state, status):
        return {
            "chaos.replies": final_state["replies"],
            "chaos.healed": final_state["heal_got"],
        }


sim_testcases = {"chaos-barrier": ChaosBarrier}
