"""additional_hosts plan, torch edition: the twin of
``plans/additional_hosts/sim.py``.

Each instance sends a request to the ``http-echo`` service, a lane past
the instance axis that the run lists in ``hosts`` (``env.host_index``),
and must get it back verbatim from that lane. ``additional_hosts_drop``
installs a DROP filter toward every data-plane region first: the echo must
still answer, since control routes bypass shaping and filters.
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

REQ = 7  # request marker word


class AdditionalHosts(SimTestcase):
    MSG_WIDTH = 2  # [kind, nonce]
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 4
    TRACK_SRC = True
    SHAPING = ("latency", "filters")
    DROP_ALL = False

    def init(self, env):
        return {"bad": torch.zeros(env.group_lanes, dtype=torch.bool, device=env.device)}

    def step(self, env, state, inbox, sync, t):
        cls = type(self)
        host = env.host_index("http-echo")  # raises if the run lists none
        nonce = env.global_seq ^ 0x0BAD5EED

        # request once the (possible) DROP filter is applied, two senders a
        # tick, so the host's IN_MSGS-slot inbox never overflows
        # torch.clamp, not Python max, on a count that is a 0-d tensor
        # (shape bucketing): max() would read it on the host every tick
        half = -(-env.test_instance_count // 2)
        window = (
            torch.clamp(half, min=1) if isinstance(half, torch.Tensor) else max(1, half)
        )
        send = t == 2 + torch.remainder(env.global_seq, window)
        ob = Outbox.single(
            # under shape bucketing the host's address is already a tensor
            host if isinstance(host, torch.Tensor)
            else self.device_constant(host, torch.int32, env.device),
            torch.stack([torch.full_like(nonce, REQ), nonce]),
            send,
            cls.OUT_MSGS,
            cls.MSG_WIDTH,
        )

        is_echo = (
            inbox.valid
            & (inbox.src == host)
            & (inbox.word(0) == REQ)
            & (inbox.word(1) == nonce)
        )
        # anything else delivered here is a transport violation
        bad = state["bad"] | (inbox.valid & ~is_echo).any(dim=0)
        got = is_echo.any(dim=0)
        status = torch.where(bad, FAILURE, torch.where(got, SUCCESS, RUNNING))

        drop_filters = torch.full(
            (len(env.groups), 1), FILTER_DROP, dtype=torch.int32, device=env.device
        )
        return self.out(
            {"bad": bad},
            status=status.to(torch.int32),
            outbox=ob,
            net_filters=drop_filters if cls.DROP_ALL else None,
            net_filters_valid=(t == 0) if cls.DROP_ALL else False,
        )


class AdditionalHostsDrop(AdditionalHosts):
    """DROP-all data plane; the control route still answers."""

    DROP_ALL = True


sim_testcases = {
    "additional_hosts": AdditionalHosts,
    "additional_hosts_drop": AdditionalHostsDrop,
}
