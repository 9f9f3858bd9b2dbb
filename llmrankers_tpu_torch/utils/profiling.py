"""Operator traces: counterpart of ``llmrankers_tpu/utils/profiling.py`` on
``torch.profiler``.

:func:`trace` holds one profiler session per process over its block (CPU
activities, and CUDA where a card is present) and writes it as a Chrome
trace. While it is open the port's span tracer (``utils.metering``) is on
and each span is also a ``torch.profiler.record_function`` range, so the
trace shows every span above the operators and kernels it launched.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

from . import metering

_session_open = False


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block into ``<profile_dir>/trace.<pid>.json`` (the path
    is what the block receives); a no-op yielding None when
    ``profile_dir`` is None. A second session in the same process raises.
    Spans recorded only because the session turned the tracer on are
    dropped when it closes: the trace holds them."""
    global _session_open
    if not profile_dir:
        yield None
        return
    if _session_open:
        raise RuntimeError("a profiler session is already open in this process")
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"trace.{os.getpid()}.json")
    tracer = metering.TRACER
    was_on, first = tracer.on, len(tracer.spans)
    _session_open = True
    tracer.ranges = torch.profiler.record_function
    metering.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield path
    finally:
        tracer.ranges = None
        if not was_on:
            metering.disable()
            del tracer.spans[first:]
        _session_open = False
    prof.export_chrome_trace(path)
