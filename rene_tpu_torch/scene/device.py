"""Scene buffers on a torch device.

Counterpart of rene_tpu/scene/device.py:417 `to_jax`: the numpy buffers
that `build_device_scene` produces are the scene's parameters in both
packages; this moves them onto `device` unchanged (same dtypes, shapes
and values).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def to_torch(buffers_np: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in buffers_np.items()}
