"""splitbrain plan, torch edition: the twins of ``plans/splitbrain/sim.py``'s
``accept``, ``drop`` and ``reject`` cases.

Nodes land in three regions by racing a signal (region = seq % 3), region
A applies a routing filter toward every region-B node, and everyone
probes everyone through a pipelined schedule (at step k, instance i probes
peer (i + 1 + k) mod N, so each (receiver, tick) sees at most one probe
and one reply). A↔B traffic must fail for ``drop`` and ``reject`` and flow
for ``accept``; ``reject`` also asserts each region-A sender's exact
REJECT count. A heal phase then restores ACCEPT and re-probes: region A's
instance i probes its nearest region-B peer i − 2.
"""

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

PROBE = 1
REPLY = 2

REGION_A = 0
REGION_B = 1
REGION_C = 2

# phases
P_SIGNAL = 0  # t==0: race the region-select signal
P_REGION = 1  # read back seq → region; region A installs filters
P_ROUNDUP = 2  # wait for everyone to be partitioned ("nodeRoundup")
P_PROBE = 3  # pipelined probe sweep
P_JUDGE = 4  # all probes sent + drain window elapsed → verdict
P_HEAL = 5  # region A restores ACCEPT and re-probes a B peer
P_DONE = 6


class _SplitBrain(SimTestcase):
    ACTION = FILTER_ACCEPT  # overridden per testcase

    STATES = ["region-select", "nodeRoundup", "healed"]
    N_REGIONS = 3
    MSG_WIDTH = 2  # word0: kind, word1: probe id
    OUT_MSGS = 2  # slot 0: replies, slot 1: own probes
    IN_MSGS = 4
    MAX_LINK_TICKS = 16
    SHAPING = ("latency", "filters")

    def init(self, env):
        def z(v=0, dtype=torch.int32):
            return torch.full((env.group_lanes,), v, dtype=dtype, device=env.device)

        return {
            "phase": z(),
            "region": z(-1),
            "k": z(),  # next probe index
            "replies": z(),  # probe replies received
            "heal_got": z(False, torch.bool),
            "rejected_total": z(),
            "deadline": z(),
        }

    @staticmethod
    def _region_counts(n):
        # signal seqs are 1..N; region = seq % 3. Under shape bucketing n
        # is a 0-d tensor: the tensor arm is the closed form of the same
        # count (x in [1, n] with x % 3 == r), as in the reference plan
        if isinstance(n, int):
            return [sum(1 for x in range(1, n + 1) if x % 3 == r) for r in range(3)]
        return [
            n // 3 if r == 0 else torch.where(n >= r, (n - r) // 3 + 1, 0)
            for r in range(3)
        ]

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        params = env.group.params
        drain = int(params["drain_ticks"]) if "drain_ticks" in params else 8
        n_a, n_b, _ = self._region_counts(n)
        phase = state["phase"]
        rejected_total = state["rejected_total"] + sync.rejected
        dev = env.device

        # --- always answer probes, whatever the phase
        kind = inbox.payload[0]
        pid = inbox.payload[1]
        v = inbox.valid
        is_probe = v & (kind == PROBE)
        got_reply = v & (kind == REPLY)
        slot = torch.argmax(is_probe.to(torch.int32), dim=0, keepdim=True)
        reply_to = inbox.src.gather(0, slot)[0]
        reply_id = pid.gather(0, slot)[0]
        send_reply = is_probe.any(dim=0)

        # --- region assignment from the signal race readback
        p_signal = phase == P_SIGNAL
        p_region = phase == P_REGION
        seq = sync.last_seq[self.state_id("region-select")]
        region = torch.where(p_region, torch.remainder(seq, 3), state["region"]).to(
            torch.int32
        )
        is_a = region == REGION_A

        roundup_done = sync.counts[self.state_id("nodeRoundup")] >= n
        p_roundup = phase == P_ROUNDUP

        # --- probe sweep: at step k probe peer (self + 1 + k) mod n
        p_probe = phase == P_PROBE
        k = state["k"]
        probing = p_probe & (k < n - 1)
        target = torch.remainder(env.global_seq + 1 + k, n)
        replies = state["replies"] + got_reply.sum(dim=0, dtype=torch.int32)
        k_next = torch.where(probing, k + 1, k)
        sweep_done = p_probe & (k >= n - 1)
        deadline = torch.where(sweep_done, t + drain, state["deadline"])

        # --- verdict (expectErrors)
        p_judge = phase == P_JUDGE
        judge = p_judge & (t >= state["deadline"])
        blocked = cls.ACTION != FILTER_ACCEPT
        expected_failures = torch.where(
            region == REGION_A,
            n_b if blocked else 0,
            torch.where(region == REGION_B, n_a if blocked else 0, 0),
        )
        replies_ok = replies == (n - 1) - expected_failures
        if cls.ACTION == FILTER_REJECT:
            expected_rejects = torch.where(is_a, 2 * n_b, 0)
        else:
            expected_rejects = torch.zeros((), dtype=torch.int32, device=dev)
        verdict_ok = replies_ok & (rejected_total == expected_rejects)

        # --- heal: region A restores ACCEPT, then probes its nearest B
        # peer until answered; the others serve replies and wait for all
        # |A| attestations on "healed"
        p_heal = phase == P_HEAL
        heal_enter = judge & verdict_ok
        heal_probe = p_heal & is_a & ~state["heal_got"]
        heal_target = (env.global_seq - 2).clamp_min(0)
        heal_got = state["heal_got"] | (
            p_heal & is_a & (got_reply & (pid == n)).any(dim=0)
        )
        all_healed = sync.counts[self.state_id("healed")] >= n_a
        finish = p_heal & all_healed & torch.where(is_a, heal_got, True)

        new_phase = torch.where(
            p_signal,
            P_REGION,
            torch.where(
                p_region,
                P_ROUNDUP,
                torch.where(
                    p_roundup & roundup_done,
                    P_PROBE,
                    torch.where(
                        sweep_done,
                        P_JUDGE,
                        torch.where(
                            heal_enter, P_HEAL, torch.where(finish, P_DONE, phase)
                        ),
                    ),
                ),
            ),
        ).to(torch.int32)
        status = torch.where(
            judge & ~verdict_ok, FAILURE, torch.where(finish, SUCCESS, RUNNING)
        ).to(torch.int32)

        # --- sends: slot 0 = reply, slot 1 = probe (sweep or heal)
        send_probe = probing | heal_probe
        probe_dst = torch.where(heal_probe, heal_target, target)
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

        # --- network config: region A applies ACTION toward region B on
        # partition entry and restores ACCEPT on heal entry (both apply to
        # the next tick's sends)
        filters_part = torch.full((3, 1), FILTER_ACCEPT, dtype=torch.int32, device=dev)
        filters_part[REGION_B] = cls.ACTION
        apply_part = p_region & is_a
        apply_heal = heal_enter & is_a
        sig_healed = heal_got & ~state["heal_got"]
        signals = (
            self.signal("region-select", when=p_signal)
            + self.signal("nodeRoundup", when=p_region)
            + self.signal("healed", when=sig_healed)
        )
        return self.out(
            {
                "phase": new_phase,
                "region": region,
                "k": k_next,
                "replies": replies,
                "heal_got": heal_got,
                "rejected_total": rejected_total,
                "deadline": deadline,
            },
            status=status,
            outbox=ob,
            signals=signals,
            net_filters=torch.where(apply_heal, FILTER_ACCEPT, filters_part).to(
                torch.int32
            ),
            net_filters_valid=apply_part | apply_heal,
            region=region,
            region_valid=p_region,
        )

    def collect_metrics(self, group, final_state, status):
        return {
            "splitbrain.region": final_state["region"],
            "splitbrain.replies": final_state["replies"],
            "splitbrain.rejected": final_state["rejected_total"],
        }


class SplitBrainAccept(_SplitBrain):
    ACTION = FILTER_ACCEPT


class SplitBrainReject(_SplitBrain):
    ACTION = FILTER_REJECT


class SplitBrainDrop(_SplitBrain):
    ACTION = FILTER_DROP


sim_testcases = {
    "accept": SplitBrainAccept,
    "reject": SplitBrainReject,
    "drop": SplitBrainDrop,
}
