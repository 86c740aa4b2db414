"""Native runtime components (C++), built on demand with the system
toolchain and cached under ``$TESTGROUND_HOME/work/bin``.

The port's copy of the reference's ``testground_tpu/native/__init__.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from .syncsvc import (
    NativeSyncService,
    build_fanin_driver,
    build_syncsvc,
    native_available,
)

__all__ = [
    "NativeSyncService",
    "build_fanin_driver",
    "build_syncsvc",
    "native_available",
]
