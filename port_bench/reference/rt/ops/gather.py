"""Frozen copy of rene_tpu_torch/ops/gather.py at commit ed2dcef.

Gathers with the semantics of the JAX calls the XLA engine ports.

JAX never raises on an index out of range, and the XLA engine gathers by
ids that lanes which missed or died still carry, or by a texture's
payload read as an image id where the texture is no image map (the
result is then discarded by a select). torch raises there (IndexError on
the CPU, a device-side assert on the card), so the XLA engine's gathers
go through these two:

* `at(table, idx)` is `table[idx]`: a negative index counts from the end,
  then the index is clamped into the table;
* `take(table, idx, dim)` is `jnp.take(table, idx, axis=dim)`: a negative
  index counts from the end, and one still out of range reads NaN (the
  least int32 for an integer table).

`host_values` gives the XLA engine's per-scene constants as python
numbers, so that loops over spheres and lights index no device tensor.
"""
from __future__ import annotations

import torch
from torch.utils.weak import WeakIdKeyDictionary


def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


def at(table: torch.Tensor, idx) -> torch.Tensor:
    """table[idx] along dim 0, as JAX indexes: wrapped, then clamped."""
    n = table.shape[0]
    if not torch.is_tensor(idx):
        idx = torch.as_tensor(idx, device=table.device)
    return table[_wrap(idx, n).clamp(0, max(n - 1, 0))]


def take(table: torch.Tensor, idx: torch.Tensor, dim: int = 0):
    """jnp.take(table, idx, axis=dim) for a 1-D `idx`: wrapped, and
    filled where still out of range."""
    n = table.shape[dim]
    i = _wrap(idx, n)
    ok = (i >= 0) & (i < n)
    g = torch.index_select(table, dim, i.clamp(0, max(n - 1, 0)))
    fill = (float("nan") if table.dtype.is_floating_point
            else torch.iinfo(table.dtype).min)
    shape = [1] * g.dim()
    shape[dim] = -1
    return torch.where(ok.view(shape), g, torch.full_like(g, fill))


_HOST = WeakIdKeyDictionary()


def host_values(t: torch.Tensor):
    """The values of a scene constant (a camera or sphere matrix, a light
    row) as python numbers, read from the device once per tensor. A
    float32 tensor's values are exact as python floats, and torch
    multiplies a float32 tensor by a python float in float32, so a
    product with them is the product with the device's scalar."""
    vals = _HOST.get(t)
    if vals is None:
        vals = _HOST[t] = t.tolist()
    return vals
