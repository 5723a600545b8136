"""Tracing / profiling utilities (SURVEY.md §6 "Tracing / profiling").

The reference had ad-hoc timers around its C++ phases. Equivalents here:

  - `PhaseTimer` — wall-clock phase accounting that waits for the
    phase's representative output before stopping the clock (dispatch
    is asynchronous, so an unsynchronized timer measures the enqueue).
  - `hlo_cost` — XLA's own FLOP/byte estimates for a jitted function,
    for roofline sanity checks without running anything.
  - `trace` — Perfetto trace context (jax.profiler), used by the CLI's
    --profile flag.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict



class PhaseTimer:
    """Accumulating wall-clock timer with device-sync-on-stop."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Time a phase; pass the phase's output array as `sync_on` (or
        call .sync(x) before exit) to force device completion."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync_on is not None:
                self.sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    @staticmethod
    def sync(x) -> None:
        """Wait until every array of `x` is computed."""
        import jax

        jax.block_until_ready(x)

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"{'phase':<28}{'total_s':>9}{'calls':>7}{'ms/call':>9}{'%':>6}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<28}{t:>9.3f}{n:>7}{t / n * 1000:>9.1f}"
                f"{100 * t / max(total, 1e-9):>6.1f}"
            )
        return "\n".join(lines)


def hlo_cost(fn, *args, **kwargs) -> dict:
    """XLA cost analysis (flops, bytes accessed) of jit(fn)(*args)."""
    import jax

    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    try:
        cost = compiled.cost_analysis()
        if isinstance(cost, (list, tuple)):
            cost = cost[0]
        return dict(cost)
    except Exception:
        return {}


@contextlib.contextmanager
def trace(log_dir: str):
    """Perfetto/TensorBoard trace of everything inside the context."""
    import jax

    with jax.profiler.trace(log_dir):
        yield
