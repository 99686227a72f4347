"""Phase timing — ``PhaseTimer`` of ``vit_tpu.runtime.profiler``, with the
same report lines.  The JAX module's roofline, preflight and trace helpers
wait for the port's benchmark (ROADMAP.md)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class PhaseTimer:
    """Accumulating wall-clock phase timer.

    Usage::

        timer = PhaseTimer()
        with timer.phase("attn"):
            out = f(x)
            torch.cuda.synchronize()
        print(timer.report())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {total*1e3:10.2f} ms total  {total/n*1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)
