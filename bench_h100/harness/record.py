"""What a run hands to the metric readers (``metrics/<name>.py``, each a
``read(record)`` that returns a number, or None when the run holds nothing
for it to read)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .trace import DeviceTrace
from .yardstick import family


@dataclass
class Record:
    conf: Dict  # the configuration file
    mix: Dict  # the traffic file
    setup_s: float
    calls: List[Dict]  # one per rerank_many call of the window
    counters: Dict[str, int]  # the program's counts over the window
    work: List[Dict]  # one per engine call of the window, as the driver kept it
    trace: Optional[DeviceTrace] = None  # with --trace 1

    @property
    def wall_s(self) -> float:
        """From the first call's start to the last call's end."""
        return self.calls[-1]["end"] - self.calls[0]["start"]

    def total(self, key: str) -> int:
        return sum(c[key] for c in self.calls)

    def idle_pct(self) -> Optional[float]:
        if self.trace is None:
            return None
        busy, _ = self.trace.busy()
        return 100.0 * (1.0 - busy / self.trace.window_s)

    def family_s(self, *families: str) -> float:
        """Device seconds of the kernel families named (``yardstick``)."""
        by = self.trace.seconds_by(family)
        return sum(by.get(f, 0.0) for f in families)
