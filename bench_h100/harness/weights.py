"""A configuration's weights, made on the device from the run's seed.

One draw of standard normals for every weight, in the served dtype, from a
``torch.Generator`` on the device; each weight is a view of it scaled in
place by its std, and norm weights are ones. The same seed gives the same
bytes, so the reference can make them again after the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Specs = List[Tuple[str, Tuple[int, ...], Optional[float]]]


@torch.no_grad()
def make(specs: Specs, seed: int, device="cuda", dtype=torch.bfloat16
         ) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, std in specs if std is not None)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    out, off = {}, 0
    for name, shape, std in specs:
        if std is None:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[off: off + n].view(shape).mul_(std)
        off += n
    return out


def getter(weights: Dict[str, torch.Tensor]):
    """``get(name)``: a weight as float32."""
    return lambda name: weights[name].float()
