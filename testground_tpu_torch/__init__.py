"""PyTorch/CUDA port of the sim execution substrate.

A second package beside ``testground_tpu`` (the JAX reference): the same
vectorized discrete-event network simulation, written over torch tensors,
with the calendar transport's two hot kernels hand-written in CUDA C++ for
Hopper (``csrc/transport.cu``).

The port imports torch and numpy, never jax and never the reference
package; where it needs a reference module's definitions it keeps its own
copy. Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the parity tests do), or, through the CLI
(``python -m testground_tpu_torch.cli``), unless ``.env.toml`` sets
``device = "cpu"`` under ``[runners."sim:torch"]``.
"""

__version__ = "0.1.0"

__all__ = [
    "api",
    "builders",
    "cli",
    "config",
    "engine",
    "healthcheck",
    "metrics",
    "rpc",
    "runners",
    "sim",
    "utils",
]
