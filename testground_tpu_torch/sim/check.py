"""The refusal messages the executor raises, with the reference's text
(``testground_tpu/sim/check.py:350-380``), so that the port refuses a
composition with the same words as the reference. The static checker
(``tg check``) is not ported yet: ROADMAP queue 1 item 9d."""

from __future__ import annotations

__all__ = [
    "netmatrix_requires_telemetry_message",
    "slo_requires_telemetry_message",
]


def slo_requires_telemetry_message(count: int, disable_metrics: bool) -> str:
    """The SLO-without-telemetry refusal."""
    return (
        f"composition declares {count} SLO rule(s) but the telemetry "
        "plane is off"
        + (
            " (disable_metrics = true wins over everything)"
            if disable_metrics
            else " — set telemetry = true in the runner config "
            "(--run-cfg telemetry=true)"
        )
        + "; refusing to run with unenforceable SLOs"
    )


def netmatrix_requires_telemetry_message(disable_metrics: bool) -> str:
    """The netmatrix-without-telemetry refusal."""
    return (
        "netmatrix = true but the telemetry plane is off"
        + (
            " (disable_metrics = true wins over everything)"
            if disable_metrics
            else " — the traffic matrix rides the telemetry chunk "
            "flush; set telemetry = true in the runner config "
            "(--run-cfg telemetry=true)"
        )
        + "; refusing to run with an unobservable matrix plane"
    )
