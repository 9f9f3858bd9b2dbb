"""Plain float32 PyTorch references of the benchmark's model families.

They import nothing of the program under test: every quantization the
configurations state (int8 weights and activations, the int8 KV cache) is
worked out here again from the benchmark's own float weights. On the card
TF32 is off (:func:`fp32`), so a float32 product is a float32 product.
"""
from __future__ import annotations

import torch


def fp32() -> None:
    """Keep float32 matmuls and convolutions out of TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
