"""``$TESTGROUND_HOME`` directory layout (``pkg/config/dirs.go``).

The port's own copy of the reference's ``testground_tpu/config/dirs.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Directories:
    home: str

    def plans(self) -> str:
        return os.path.join(self.home, "plans")

    def sdks(self) -> str:
        return os.path.join(self.home, "sdks")

    def work(self) -> str:
        return os.path.join(self.home, "data", "work")

    def outputs(self) -> str:
        return os.path.join(self.home, "data", "outputs")

    def daemon(self) -> str:
        return os.path.join(self.home, "data", "daemon")

    def all(self) -> list[str]:
        return [
            self.home,
            self.plans(),
            self.sdks(),
            self.work(),
            self.outputs(),
            self.daemon(),
        ]
