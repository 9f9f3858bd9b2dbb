"""The modules a run of the port may not load: JAX and the JAX package the
port was made from. A module counts by its top-level name, the part of its
name before the first dot, compared whole: ``llmrankers_tpu_torch`` is the
port and passes, ``llmrankers_tpu`` is the JAX package and does not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "llmrankers_tpu"})


def forbidden(names: Iterable[str] = None) -> List[str]:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
