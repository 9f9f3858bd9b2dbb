"""Host spans, and the device trace of a window.

:class:`Spans` keeps the harness's own spans in memory: around each call
into the ranker and each call the ranker makes into the engine. A window's
device trace comes from one ``torch.profiler`` session per process that
traces the device only. Two marker kernels, launched on an idle device just
after the host reads its clock at the window's start and end, map device
timestamps onto the host clock, so idle gaps can be labelled by the span
that was open.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch


class Spans:
    """Named host intervals (perf_counter seconds); nesting is by time."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def wrap(self, obj, method: str, name: str):
        """Put every call of ``obj.method`` inside a span ``name``."""
        inner = getattr(obj, method)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return inner(*args, **kwargs)

        setattr(obj, method, wrapped)

    def label(self, t: float, default: str = "harness") -> str:
        """The innermost span open at host time ``t``."""
        best: Optional[Tuple[float, str]] = None
        for name, t0, t1 in self.items:
            if t0 <= t <= t1 and (best is None or t1 - t0 < best[0]):
                best = (t1 - t0, name)
        return best[1] if best else default


class DeviceTrace:
    """One profiler session over a window: ``start()`` before it, ``stop()``
    after; then ``ops`` holds (name, host start s, seconds) of every device
    operation inside the window, and ``t0``/``t1`` its host bounds."""

    def __init__(self):
        self._marker = torch.zeros(1, device="cuda")
        self.ops: List[Tuple[str, float, float]] = []

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self._marker.add_(1)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._marker.add_(1)
        torch.cuda.synchronize()
        tic = time.perf_counter()
        self._prof.__exit__(None, None, None)
        toc = time.perf_counter()
        cuda = torch.autograd.DeviceType.CUDA
        dev = [(e.start_ns(), e.duration_ns(), e.name())
               for e in self._prof.profiler.kineto_results.events() if e.device_type() == cuda]
        del self._prof
        self.cost_s = {"profiler_stop": toc - tic, "read": time.perf_counter() - toc}
        dev.sort()
        if len(dev) < 3:
            raise RuntimeError(f"the profiler recorded {len(dev)} device operations")
        (m0, d0, _), (m1, _, _) = dev[0], dev[-1]
        scale = (self.t1 - self.t0) / max(m1 - m0, 1)
        lo = m0 + d0
        self.ops = [(name, self.t0 + (s - m0) * scale, d * 1e-9)
                    for s, d, name in dev[1:-1] if s >= lo]

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy(self) -> Tuple[float, List[Tuple[float, float]]]:
        """(seconds some operation ran, the idle gaps as (start, seconds))."""
        busy, gaps = 0.0, []
        cur_s, cur_e = None, self.t0
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            e = s + d
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s - cur_e))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, self.t1 - cur_e))
        return busy, [g for g in gaps if g[1] > 0]

    def seconds_by(self, key) -> Dict[str, float]:
        """Device seconds summed by ``key(name)``."""
        out: Dict[str, float] = {}
        for name, _, d in self.ops:
            k = key(name)
            out[k] = out.get(k, 0.0) + d
        return out

    def breakdown(self, spans: Spans, n: int = 10) -> Dict[str, list]:
        """The ``n`` device operations that took most time, and the ``n``
        longest idle gaps labelled by the host span open at their middle."""
        ops = sorted(self.seconds_by(lambda s: s).items(), key=lambda kv: -kv[1])[:n]
        _, gaps = self.busy()
        gaps = sorted(gaps, key=lambda g: -g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[spans.label(s + d / 2), d] for s, d in gaps]}
