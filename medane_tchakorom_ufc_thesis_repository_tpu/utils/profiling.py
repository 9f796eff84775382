"""Phase profiling: named stages + wall timers + optional XLA traces.

The analog of the reference's PetscLog usage (SURVEY.md §5.1): every
driver registers stages "Loading" / "I_Solver" / "O_Solver" / "Last" and
fences with barriers around the solve loop
(``synchronous-multisplitting.c:52-62,166-217``).  Here:

* ``PhaseTimer`` — host-side named wall-clock stages with device fencing
  (``jax.block_until_ready``);
* ``trace(logdir)`` — ``jax.profiler`` trace context for XLA device
  timelines (the analog of ``-log_view ::ascii_flamegraph``);
* ``annotate(name)`` — named TraceAnnotation scope visible in traces.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple



def fence(arr) -> None:
    """Wait until the device has finished computing ``arr`` (a pytree)."""
    import jax

    jax.block_until_ready(arr)


class PhaseTimer:
    """Accumulating named-stage wall timers.

    >>> pt = PhaseTimer()
    >>> with pt.phase("I_Solver", fence_on=x):
    ...     x = step(x)
    >>> pt.report()
    """

    def __init__(self):
        self._acc: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []

    @contextlib.contextmanager
    def phase(self, name: str, fence_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence_on is not None:
                fence(fence_on)
            dt = time.perf_counter() - t0
            if name not in self._acc:
                self._acc[name] = 0.0
                self._counts[name] = 0
                self._order.append(name)
            self._acc[name] += dt
            self._counts[name] += 1

    def items(self) -> List[Tuple[str, float, int]]:
        return [(k, self._acc[k], self._counts[k]) for k in self._order]

    def report(self, printer=print) -> None:
        total = sum(self._acc.values()) or 1.0
        printer(f"{'stage':<16s} {'time_s':>10s} {'calls':>7s} {'share':>7s}")
        for name, t, c in self.items():
            printer(f"{name:<16s} {t:>10.4f} {c:>7d} {t / total:>6.1%}")


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """XLA profiler trace (no-op when logdir is None)."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield


def annotate(name: str):
    """Named scope visible in profiler timelines."""
    import jax

    return jax.profiler.TraceAnnotation(name)
