"""A copy of adafocus_tpu/train/preemption.py (the port imports nothing
of the JAX package).

Preemption handling — checkpoint-on-signal + requeue.

Parity with the reference's SLURM handler (the reference
actnet/basic_tools/checkpoint.py:29-45: SIGUSR1 -> save + ``scontrol
requeue``), generalized: any signal set, an optional requeue command, and
a cooperative flag the train loop polls so the checkpoint is written at a
step boundary (the reference saves from inside the signal handler, which
can race the optimizer step).
"""

from __future__ import annotations

import os
import signal
import subprocess
from typing import Callable, Iterable, Optional


class PreemptionGuard:
    """Install with ``guard = PreemptionGuard.install()``; poll
    ``guard.should_stop`` each step; call ``guard.finalize(save_fn)``
    once training exits."""

    def __init__(self, requeue_cmd: Optional[str] = None):
        self.should_stop = False
        self._signaled = None
        self.requeue_cmd = requeue_cmd
        self._previous = {}

    @classmethod
    def install(
        cls,
        signals: Iterable[int] = (signal.SIGUSR1, signal.SIGTERM),
        requeue_cmd: Optional[str] = None,
    ) -> "PreemptionGuard":
        guard = cls(requeue_cmd)

        def handler(signum, frame):
            guard.should_stop = True
            guard._signaled = signum

        for s in signals:
            try:
                guard._previous[s] = signal.signal(s, handler)
            except (ValueError, OSError):
                pass  # non-main thread / unsupported platform
        return guard

    def uninstall(self) -> None:
        """Put back the handlers ``install`` replaced (for a CLI run inside
        a longer process, such as a test or a smoke script)."""
        for s, previous in self._previous.items():
            signal.signal(s, previous)
        self._previous = {}

    @property
    def preempted(self) -> bool:
        return self._signaled is not None

    def finalize(self, save_fn: Optional[Callable[[], None]] = None) -> None:
        """Run after the loop exits: save, then requeue if preempted.
        Default requeue: ``scontrol requeue $SLURM_JOB_ID`` when running
        under SLURM (reference checkpoint.py:38-44)."""
        if not self.preempted:
            return
        if save_fn is not None:
            save_fn()
        cmd = self.requeue_cmd
        if cmd is None and os.environ.get("SLURM_JOB_ID"):
            cmd = f"scontrol requeue {os.environ['SLURM_JOB_ID']}"
        if cmd:
            subprocess.run(cmd.split(), check=False)
