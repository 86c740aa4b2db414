"""network plan, exec edition: REAL TCP sockets between real processes.

The real-process twin of ``plans/network`` ping-pong (reference
``pingpong.go``): pairs discover each other through the sync service
(address exchange via Publish/Subscribe — the reference's peer-routing
pattern), open a real TCP connection, exchange ping/pong rounds, and
measure RTTs. Like the reference's ``local:exec`` runner, there is no
kernel link shaping here (``TestSidecar=false``, ``local_exec.go:89``) —
shaped-latency assertions are the sim edition's job; this edition proves
the SDK's data-plane path end to end: listener sockets, sync-service
address exchange, and real traffic between OS processes (BASELINE
config 1: network ping-pong, 2 instances, local:exec).
"""

import socket
import time

from testground_tpu_torch.sdk import invoke_map

ROUNDS = 2
BARRIER_TIMEOUT = 60.0  # a crashed peer must fail us, not hang us


def _pair_of(seq: int) -> int:
    """1-based pairing: (1,2), (3,4), ... — 0 means no partner (odd N)."""
    partner = seq + 1 if seq % 2 == 1 else seq - 1
    return partner


def _recv_exact(conn: socket.socket, k: int) -> bytes:
    """TCP is a stream: loop until exactly ``k`` bytes (or EOF)."""
    buf = b""
    while len(buf) < k:
        chunk = conn.recv(k - len(buf))
        if not chunk:
            return buf
        buf += chunk
    return buf


def ping_pong(runenv, initctx):
    client = initctx.sync_client
    n = runenv.test_instance_count
    seq = client.signal_entry("enrolled")
    partner = _pair_of(seq)
    if partner > n:
        runenv.record_message("odd instance count: %d runs solo", seq)
        return None

    # listener first, then publish the address and wait for everyone —
    # no dial can happen before every listener is up
    lis = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lis.bind(("127.0.0.1", 0))
    lis.listen(1)
    lis.settimeout(30.0)
    port = lis.getsockname()[1]
    client.publish("addrs", {"seq": seq, "port": port})
    dialer = seq < partner
    if dialer:  # only the dialer needs the address map
        partner_port = None
        for entry in client.subscribe("addrs", timeout=30.0):
            if int(entry["seq"]) == partner:
                partner_port = int(entry["port"])
                break
        if partner_port is None:
            return f"partner {partner} never published an address"
    client.signal_and_wait(
        "listening", n - (n % 2), timeout=BARRIER_TIMEOUT
    )  # solo skips this barrier

    if dialer:
        conn = socket.create_connection(
            ("127.0.0.1", partner_port), timeout=30.0
        )
    else:
        conn, _ = lis.accept()
    conn.settimeout(30.0)

    try:
        for rnd in range(1, ROUNDS + 1):
            if dialer:
                t0 = time.monotonic()
                conn.sendall(b"ping%d" % rnd)
                got = _recv_exact(conn, 5)
                rtt_ms = (time.monotonic() - t0) * 1000.0
                if got != b"pong%d" % rnd:
                    return f"round {rnd}: expected pong, got {got!r}"
                runenv.R().record_point(f"rtt_round{rnd}_ms", rtt_ms)
                runenv.record_message(
                    "round %d rtt: %.3f ms", rnd, rtt_ms
                )
            else:
                got = _recv_exact(conn, 5)
                if got != b"ping%d" % rnd:
                    return f"round {rnd}: expected ping, got {got!r}"
                conn.sendall(b"pong%d" % rnd)
        # both sides confirm completion before sockets drop
        client.signal_and_wait(
            "done", n - (n % 2), timeout=BARRIER_TIMEOUT
        )
    finally:
        conn.close()
        lis.close()
    return None


def _sim_only(case: str):
    def run(runenv, initctx):
        return (
            f"testcase {case!r} has no exec edition — run it on the "
            "sim:jax runner (its link shaping needs the simulated "
            "transport)"
        )

    return run


if __name__ == "__main__":
    invoke_map(
        {
            "ping-pong": ping_pong,
            # manifest-advertised cases without a real-process edition
            # fail cleanly with a pointer instead of exiting 2
            "traffic-allowed": _sim_only("traffic-allowed"),
            "traffic-blocked": _sim_only("traffic-blocked"),
            "traffic-shaped": _sim_only("traffic-shaped"),
            "pingpong-sustained": _sim_only("pingpong-sustained"),
        }
    )
