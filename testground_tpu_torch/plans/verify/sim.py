"""verify plan, torch edition: the twins of ``plans/verify/sim.py``'s
``uses-data-network`` and ``uses-data-network-drop`` cases.

The invariant: a message reaches an instance only through the shaped
data-plane transport, checksum-exact as the link model delivered it.

- ``uses-data-network``: the target (rank 1 on the "ready" signal)
  publishes its data-plane address and a control-plane address (index +
  N, outside the data plane) on the "addrs" topic; pingers ping both, one
  pinger a tick. Every data ping must come back as a checksum-verified
  pong; no control ping may arrive. Any corrupt checksum, forged sender or
  out-of-plane delivery is a FAILURE.
- ``uses-data-network-drop``: every pinger installs a DROP filter toward
  every region first; the target must receive nothing and the pingers no
  pong. Sync still flows: coordination rides the control plane.
"""

import torch

from testground_tpu_torch.sim.api import (
    FAILURE,
    FILTER_DROP,
    RUNNING,
    SUCCESS,
    Outbox,
    SimTestcase,
)

PING = 1
PONG = 2
END_OF_NETWORKS = -1  # the "endOfNetworks" sentinel

GOLD = -1640531527  # 0x9E3779B9 as int32 — checksum mixing constant


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values → int32 with two's-complement wraparound."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _checksum(src, seq):
    """Payload checksum keyed on sender identity + sequence, in int32
    wraparound arithmetic (computed in int64 and wrapped)."""
    i64 = torch.int64
    return _wrap32(src.to(i64) * GOLD) ^ _wrap32(seq.to(i64) + 0x5EED)


class UsesDataNetwork(SimTestcase):
    STATES = ["ready", "target-ready", "finished"]
    TOPICS = ["addrs"]
    MSG_WIDTH = 3  # [kind, checksum, seq]
    OUT_MSGS = 4  # target echoes a full inbox; pingers use slots 0-1
    IN_MSGS = 4
    PUB_WIDTH = 2  # [addr, is_end]
    SUB_K = 4
    MAX_LINK_TICKS = 4
    SHAPING = ("latency", "filters")
    DROP_ALL = False  # the -drop testcase flips this
    # in-flight pongs settle before the loss verdict: a round trip is at
    # most 2·(MAX_LINK_TICKS-1) hops, +2 for the target's processing tick
    # and the verdict tick
    DRAIN_TICKS = 2 * (MAX_LINK_TICKS - 1) + 2

    def init(self, env):
        def z(v=0, dtype=torch.int32):
            return torch.full((env.group_lanes,), v, dtype=dtype, device=env.device)

        return {
            "addr_data": z(-1),
            "addr_ctrl": z(-1),
            "addrs_seen": z(),
            "pub_idx": z(),
            "sent": z(),
            "done_at": z(-1),
            "pongs_data": z(),
            "recv": z(),
            "bad": z(False, torch.bool),
            "sig_finished": z(False, torch.bool),
        }

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        n = env.test_instance_count
        params = env.group.params
        pings = int(params["pings"]) if "pings" in params else 8
        i32 = torch.int32

        rank = sync.last_seq[self.state_id("ready")]
        is_target = rank == 1
        is_pinger = rank > 1
        me = env.global_seq
        ones = torch.ones_like(me)

        # ------------------------------------------------- inbox validation
        kind = inbox.word(0)
        csum = inbox.word(1)
        seq = inbox.word(2)
        ok_sum = csum == _checksum(inbox.src, seq)
        got_ping = inbox.valid & (kind == PING)
        got_pong = inbox.valid & (kind == PONG)
        bad = state["bad"] | (inbox.valid & ~ok_sum).any(dim=0)

        # --------------------------------------------------- target: publish
        # addrs entries over 3 ticks: data addr, control addr, END
        entries = torch.stack([
            torch.stack([me, 0 * ones]),
            torch.stack([me + n, 0 * ones]),
            torch.stack([END_OF_NETWORKS * ones, ones]),
        ])  # [3, PW, n]
        can_pub = is_target & (state["pub_idx"] < 3) & (t >= 1)
        which = state["pub_idx"].clamp_max(2).to(torch.int64)
        pub_payload = entries.gather(0, which[None, None, :].expand(1, 2, -1))
        pub_idx = state["pub_idx"] + can_pub.to(i32)
        sig_target_ready = is_target & (pub_idx >= 3) & (state["pub_idx"] < 3)

        # the target echoes every valid ping back to its sender, re-stamped
        # with its own provenance
        echo = Outbox(
            dst=inbox.src,
            payload=torch.stack(
                [torch.full_like(kind, PONG), _checksum(me, seq), seq], dim=1
            ),
            valid=got_ping & is_target & ok_sum,
        )
        recv = state["recv"] + got_ping.sum(dim=0, dtype=i32)

        # ------------------------------------------------- pinger: subscribe
        sub_pay = sync.sub_payload[0]  # [SUB_K, PW, n]
        sub_val = sync.sub_valid[0]  # [SUB_K, n]
        target_ready = sync.counts[self.state_id("target-ready")] >= 1
        k_idx = torch.arange(cls.SUB_K, dtype=i32, device=env.device)[:, None]
        take = sub_val & (k_idx < 3 - state["addrs_seen"]) & is_pinger
        ent_idx = state["addrs_seen"] + k_idx
        is_data = take & (ent_idx == 0)
        is_ctrl = take & (ent_idx == 1)

        def addr(hit, old):
            picked = torch.where(hit, sub_pay[:, 0, :], 0).sum(dim=0).to(i32)
            return torch.where(hit.any(dim=0), picked, old)

        addr_data = addr(is_data, state["addr_data"])
        addr_ctrl = addr(is_ctrl, state["addr_ctrl"])
        ncons = take.sum(dim=0, dtype=i32)
        addrs_seen = state["addrs_seen"] + ncons

        # --------------------------------------------------- pinger: pinging
        have_addrs = addrs_seen >= 3
        # staggered: a pinger fires on ticks ≡ its index (mod N)
        my_slot = torch.remainder(t, n) == torch.remainder(me, n)
        send = (
            is_pinger & have_addrs & my_slot & (state["sent"] < pings) & target_ready
        )
        pseq = state["sent"]
        sent = state["sent"] + send.to(i32)
        done_at = torch.where(
            (state["done_at"] < 0) & (sent >= pings), t, state["done_at"]
        )

        # slot 0 pings the data address, slot 1 the control address (out
        # of plane: the transport must never deliver it)
        ping_payload = torch.stack([PING * ones, _checksum(me, pseq), pseq])  # [3, n]
        zero_row = torch.zeros_like(me)
        ob = Outbox(
            dst=torch.stack([addr_data, addr_ctrl, zero_row, zero_row]),
            payload=torch.stack([
                ping_payload,
                ping_payload,
                torch.zeros_like(ping_payload),
                torch.zeros_like(ping_payload),
            ]),
            valid=torch.stack([send, send, send & False, send & False]),
        )
        outbox = Outbox(
            dst=torch.where(is_target, echo.dst, ob.dst),
            payload=torch.where(is_target, echo.payload, ob.payload),
            valid=torch.where(is_target, echo.valid, ob.valid),
        )

        pongs_data = state["pongs_data"] + (got_pong & ok_sum).sum(dim=0, dtype=i32)

        # ------------------------------------------------------- the verdict
        expected = (0 if cls.DROP_ALL else 1) * pings
        pinger_done = (done_at >= 0) & (t >= done_at + cls.DRAIN_TICKS)
        pinger_ok = pinger_done & (pongs_data == expected)
        pinger_bad = pinger_done & (pongs_data != expected)
        fin_target = (0 if cls.DROP_ALL else 1) * (n - 1) * pings
        target_bad = is_target & (recv > fin_target)

        sig_finished = (pinger_ok | (is_target & (t >= 1))) & ~state["sig_finished"]
        all_done = sync.counts[self.state_id("finished")] >= n
        status = torch.where(
            bad | pinger_bad | target_bad,
            FAILURE,
            torch.where(all_done, SUCCESS, RUNNING),
        ).to(i32)

        # DROP-all: a DROP filter toward every region the tick the rank is
        # known, before any ping flies
        drop_filters = torch.full(
            (len(env.groups), 1), FILTER_DROP, dtype=i32, device=env.device
        )
        return self.out(
            {
                "addr_data": addr_data,
                "addr_ctrl": addr_ctrl,
                "addrs_seen": addrs_seen,
                "pub_idx": pub_idx,
                "sent": sent,
                "done_at": done_at,
                "pongs_data": pongs_data,
                "recv": recv,
                "bad": bad,
                "sig_finished": state["sig_finished"] | sig_finished,
            },
            status=status,
            outbox=outbox,
            signals=self.signal("ready", when=t == 0)
            + self.signal("target-ready", when=sig_target_ready)
            + self.signal("finished", when=sig_finished),
            pub_payload=pub_payload,
            pub_valid=can_pub[None, :],
            sub_consume=ncons[None, :],
            net_filters=drop_filters if cls.DROP_ALL else None,
            net_filters_valid=((t == 1) & is_pinger) if cls.DROP_ALL else False,
        )

    def collect_metrics(self, group, final_state, status):
        return {
            "pongs_received": final_state["pongs_data"],
            "pings_delivered_to_target": final_state["recv"],
        }


class UsesDataNetworkDrop(UsesDataNetwork):
    """DROP-all variant: the transport must deliver nothing."""

    DROP_ALL = True


sim_testcases = {
    "uses-data-network": UsesDataNetwork,
    "uses-data-network-drop": UsesDataNetworkDrop,
}
