"""Statistics counters and render-time logging (port of
mitsuba_tpu/util/stats.py).

Named counters printed as a table at the end of a job, the reference's
StatsCounter registry and Logger (ref: include/mitsuba/core/
statistics.h:55-94,339; logger.h:119). Device-side counts (rays traced)
arrive as 0-d tensors or ints from the integrators; host-side counters
(passes, seconds) update eagerly. `print_stats()` renders the table.
"""
from __future__ import annotations

import logging
import sys
import time
from collections import defaultdict

log = logging.getLogger("mitsuba_tpu_torch")
if not log.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s", "%H:%M:%S"))
    log.addHandler(_h)
    log.setLevel(logging.INFO)

_counters: dict[str, float] = defaultdict(float)


def counter_add(name: str, value) -> None:
    _counters[name] += float(value)


def counter_get(name: str) -> float:
    return _counters[name]


def reset_stats() -> None:
    _counters.clear()


def format_stats() -> str:
    """Reference-style statistics table (statistics.h:339 printStats)."""
    if not _counters:
        return "  (no statistics collected)"
    width = max(len(k) for k in _counters) + 2
    lines = ["-" * (width + 24)]
    for k in sorted(_counters):
        v = _counters[k]
        if v >= 1e9:
            s = f"{v / 1e9:.3f} G"
        elif v >= 1e6:
            s = f"{v / 1e6:.3f} M"
        elif v >= 1e3:
            s = f"{v / 1e3:.3f} K"
        else:
            s = f"{v:.1f}"
        lines.append(f"  {k:<{width}}: {s}")
    lines.append("-" * (width + 24))
    return "\n".join(lines)


def print_stats() -> None:
    print(format_stats(), file=sys.stderr)


class ProgressReporter:
    """Console progress bar with an ETA (ref: statistics.h:287)."""

    def __init__(self, title: str, total: int, quiet: bool = False):
        self.title = title
        self.total = max(total, 1)
        self.t0 = time.time()
        self.done = 0
        self.quiet = quiet

    def update(self, done: int) -> None:
        self.done = done
        if self.quiet:
            return
        frac = done / self.total
        elapsed = time.time() - self.t0
        eta = elapsed / max(frac, 1e-6) * (1 - frac)
        bar = "#" * int(32 * frac) + "-" * (32 - int(32 * frac))
        sys.stderr.write(
            f"\r{self.title}: [{bar}] {100 * frac:5.1f}% "
            f"({elapsed:.1f}s, ETA {eta:.1f}s)")
        if done >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()
