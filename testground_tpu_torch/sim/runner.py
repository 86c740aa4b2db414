"""``sim:torch`` runner: runs a composition's run through the port's
executor — the counterpart of the reference's ``SimJaxRunner``
(``testground_tpu/sim/runner.py:50-152``).

Its healthcheck is the torch counterpart of the reference's device checks:
torch imports, the run's device answers, the transport kernels build from
``csrc/transport.cu`` and K2 launches bit-equal to its plain version, and
device memory is not exhausted — plus the outputs dir with a mkdir fixer.
The checked device is the run's: its coalesced config's ``device`` when a
run asks, else the env's ``[runners."sim:torch"]`` layer's; the card
unless one of them sets another, such as ``device = "cpu"``. Without a card
and without such a setting the check fails (the port never drops to the CPU
on its own).
"""

from __future__ import annotations

import threading

from ..api import RunInput, RunOutput
from ..rpc import OutputWriter
from ..runners.base import HealthcheckedRunner, Runner, Terminatable

__all__ = ["SimTorchRunner"]


_kernel_check_ok: dict[tuple, str] = {}


def _kernel_check(device) -> tuple[bool, str]:
    """Build the kernels and pop a small calendar plane with K2 on
    ``device``, bit-equal to the plain version. Only SUCCESS is cached per
    device (the supervisor healthchecks every run, but a transient failure
    must not poison the process)."""
    import torch

    from . import cuda_transport as ct
    from .engine import device_context

    key = (str(device), torch.cuda.get_device_name(device))
    if key in _kernel_check_ok:
        return True, _kernel_check_ok[key]
    path, build_s, _ = ct.build_kernels()
    # K2 launches on the current device: make it the checked one
    with device_context(device):
        ok = _pop_check(device)
    if not ok:
        return False, "K2 disagrees with its plain version"
    msg = (f"kernels built ({path.rsplit('/', 1)[-1]}, {build_s:.1f}s) and "
           f"K2 bit-equal to its plain version on {device}")
    _kernel_check_ok[key] = msg
    return True, msg


def _pop_check(device) -> bool:
    """K2 on a small random calendar plane on ``device``, bit-equal to its
    plain version."""
    import torch

    from . import cuda_transport as ct
    from .net import Calendar

    gen = torch.Generator().manual_seed(0)
    horizon, ns, width = 4, 2 * 64, 2

    def plane(lo, hi):
        return torch.randint(lo, hi, (horizon, ns), generator=gen, dtype=torch.int32)

    host = Calendar(payload=tuple(plane(-(2**31), 2**31 - 1) for _ in range(width)),
                    src=plane(0, 65), valid=None, slots=2)
    cals = [
        Calendar(payload=tuple(p.to(device) for p in host.payload),
                 src=host.src.to(device), valid=None, slots=2)
        for _ in range(2)
    ]
    t = torch.tensor(horizon + 1, dtype=torch.int32, device=device)
    _, row_k, pay_k = ct.pop_bucket(cals[0], t)
    _, row_p, pay_p = ct.pop_bucket_plain(cals[1], t)
    got = [cals[0].src, *cals[0].payload, row_k, *pay_k]
    want = [cals[1].src, *cals[1].payload, row_p, *pay_p]
    return all(torch.equal(a, b) for a, b in zip(got, want))


class SimTorchRunner(Runner, HealthcheckedRunner, Terminatable):
    def id(self) -> str:
        return "sim:torch"

    def compatible_builders(self) -> list[str]:
        return ["sim:plan"]

    def config_type(self) -> type | None:
        from .executor import SimTorchConfig

        return SimTorchConfig

    def terminate_all(self, ow: OutputWriter) -> None:
        """In-flight device dispatches stop at the next chunk boundary via
        the task's cancel event; no containers/services persist a run."""
        ow.infof("sim:torch: no persistent resources to terminate")

    def healthcheck(self, fix: bool, ow: OutputWriter, env=None, config=None):
        from ..config import EnvConfig
        from ..healthcheck import Helper, checkers, fixers

        if env is None:  # observe the environment, don't repair it
            env = EnvConfig.load(ensure_dirs=False)
        if config is not None:
            configured = config.device
        else:
            configured = env.runner_config(self.id()).get("device")

        def run_device():
            from .engine import resolve_device

            return resolve_device(configured)

        def torch_importable():
            import torch

            return True, f"torch {torch.__version__}, CUDA {torch.version.cuda}"

        def device_available():
            import torch

            dev = run_device()
            if dev.type != "cuda":
                return True, f"device {dev} (runner config device={configured!r})"
            return True, (f"{torch.cuda.device_count()} device(s): "
                          f"{torch.cuda.get_device_name(dev)}")

        def kernel_buildable():
            dev = run_device()
            if dev.type != "cuda":
                return True, f"device {dev} runs the kernels' plain versions"
            return _kernel_check(dev)

        def device_memory():
            import torch

            dev = run_device()
            if dev.type != "cuda":
                return True, f"memory stats unavailable on {dev}"
            # live allocations, as the reference's bytes_in_use: neither the
            # caching allocator's idle blocks nor other processes count
            in_use = torch.cuda.memory_allocated(dev)
            total = torch.cuda.get_device_properties(dev).total_memory
            frac = in_use / total
            if frac > 0.95:
                return False, (f"device memory nearly exhausted: "
                               f"{in_use}/{total} bytes in use")
            return True, f"{in_use}/{total} bytes in use ({frac:.0%})"

        h = Helper()
        h.enlist("torch-importable", torch_importable,
                 fixers.requires_manual_fixing("install torch"))
        h.enlist("device-available", device_available,
                 fixers.requires_manual_fixing(
                     'attach a CUDA device, or set device = "cpu" under '
                     '[runners."sim:torch"] in .env.toml'))
        h.enlist("kernel-buildable", kernel_buildable)
        h.enlist("device-memory", device_memory)
        h.enlist(
            "outputs-dir-writable",
            checkers.check_dir_writable(env.dirs.outputs()),
            fixers.create_directory(env.dirs.outputs()),
        )
        return h.run_checks(fix, ow)

    def run(
        self, job: RunInput, ow: OutputWriter, cancel: threading.Event
    ) -> RunOutput:
        from .executor import execute_sim_run

        return execute_sim_run(job, ow, cancel)
