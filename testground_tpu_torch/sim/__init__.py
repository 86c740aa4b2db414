"""The ``sim`` execution substrate over torch: the same module names as the
reference's ``testground_tpu/sim`` (``net.py`` ↔ ``net.py``), so every port
module has one counterpart to be held against.

Import layering: the package root imports nothing; submodules import torch.
The CUDA kernels are built and loaded on first use, never at import.
"""

__all__ = [
    "api",
    "carry_io",
    "check",
    "cuda_transport",
    "engine",
    "executor",
    "faults",
    "meshplan",
    "net",
    "netmatrix",
    "pack",
    "prng",
    "slo",
    "sync_kernel",
    "telemetry",
    "trace",
]
