"""Brute-force triangle intersection through matrix products of Plücker
coordinates: the port of rene_tpu/ops/mxu_intersect.py.

The three edge side tests of a ray against a triangle are linear in the
ray's Plücker coordinates (d, w = o x d):

    side(edge a->b) = d . (a x b) + w . (b - a)

so testing N rays against C triangles is one (3C, 6) @ (6, N) product,
plus (C, 4) @ (4, N) and (C, 3) @ (3, N) products for the plane's t =
(k - o.n) / (d.n). A ray hits where all three sides share a sign (no
backface culling). Everything stays in the (C, N) orientation of the
reference, the ray dimension minor.

The constant matrices B, P_on and P_dn are built in numpy exactly as the
reference builds them. The products are plain large matrix products that
the reference leaves to XLA outside any kernel, so here they are
torch.matmul on the intersector's device, in full float32: the float32
matmul precision is set to "highest" around them (a card would otherwise
be free to take TF32, which keeps about three decimal digits and moves
side signs near an edge).

Barycentrics of the winning triangle come from its signed side values:
with edges E0: v0->v1, E1: v1->v2, E2: v2->v0, bary(v1) = s2 / (s0 + s1 +
s2) and bary(v2) = s0 / (s0 + s1 + s2).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

NO_HIT = 1e30


@contextlib.contextmanager
def _highest():
    """torch.matmul in full float32 inside, the previous setting after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


class MXUIntersector:
    """The triangles' constant matrices and the product test, on
    `device`, which every caller names (no default: a card's caller that
    left it out would run the products on the host unseen)."""

    def __init__(self, tri_p, device):
        tri_p = np.asarray(tri_p, np.float64)
        ntri = tri_p.shape[0]
        pad = (-ntri) % 8
        self.num_tris = ntri
        self.padded = ntri + pad
        v0 = np.concatenate([tri_p[:, 0], np.zeros((pad, 3))], 0)
        v1 = np.concatenate([tri_p[:, 1], np.zeros((pad, 3))], 0)
        v2 = np.concatenate([tri_p[:, 2], np.ones((pad, 3))], 0)

        def edge_rows(a, b):
            # side = d . (a x b) + (o x d) . (b - a)
            return np.concatenate([np.cross(a, b), b - a], axis=1)  # (C,6)

        # B rows: contiguous blocks [E0 | E1 | E2] -> (3C, 6)
        self.B = np.ascontiguousarray(np.concatenate(
            [edge_rows(v0, v1), edge_rows(v1, v2), edge_rows(v2, v0)],
            axis=0), np.float32)
        n = np.cross(v1 - v0, v2 - v0)  # (C,3) geometric normal
        k = np.sum(n * v0, axis=1)      # plane offset
        # P rows: [-n | k] gives (k - o.n) against [o;1]; [n] gives d.n
        self.P_on = np.ascontiguousarray(
            np.concatenate([-n, k[:, None]], axis=1), np.float32)  # (C,4)
        self.P_dn = np.ascontiguousarray(n, np.float32)            # (C,3)
        self.device = torch.device(device)
        self._device = None

    def to_device(self, device=None):
        """The constant matrices as tensors on `device` (the
        intersector's own by default)."""
        if device is not None:
            self.device = torch.device(device)
        self._device = {k: torch.from_numpy(getattr(self, k)).to(self.device)
                        for k in ("B", "P_on", "P_dn")}
        return self

    def _rays(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, np.float32))
        return x.to(dtype=torch.float32, device=self.device)

    def sides(self, org, direction) -> torch.Tensor:
        """The (3C, N) signed side values [E0; E1; E2] of every triangle
        against the (N, 3) rays."""
        if self._device is None:
            self.to_device()
        org, direction = self._rays(org), self._rays(direction)
        w = torch.cross(org, direction, dim=1)
        feat_t = torch.cat([direction, w], dim=1).T.contiguous()  # (6, N)
        with _highest():
            return torch.matmul(self._device["B"], feat_t)

    def intersect(self, org, direction, tmin, tmax, want_bary=False):
        """Closest hit of each of the (N, 3) rays: (t, prim_id[, u, v]),
        t = 1e30 and id 0 where none hits."""
        if self._device is None:
            self.to_device()
        d = self._device
        c = self.padded
        org, direction = self._rays(org), self._rays(direction)
        tmin, tmax = self._rays(tmin), self._rays(tmax)
        s = self.sides(org, direction)
        s0, s1, s2 = s[:c], s[c:2 * c], s[2 * c:]
        pos = (s0 >= 0) & (s1 >= 0) & (s2 >= 0)
        neg = (s0 <= 0) & (s1 <= 0) & (s2 <= 0)
        on_t = torch.cat([org, torch.ones_like(org[:, :1])], dim=1).T
        with _highest():
            pp = torch.matmul(d["P_on"], on_t.contiguous())
            dn = torch.matmul(d["P_dn"], direction.T.contiguous())
        t = pp / torch.where(dn.abs() > 1e-12, dn, dn.new_tensor(1e-12))
        valid = ((pos | neg) & (dn.abs() > 1e-12)
                 & (t >= tmin[None, :]) & (t <= tmax[None, :]))
        if self.padded != self.num_tris:
            row = torch.arange(c, device=self.device)[:, None]
            valid = valid & (row < self.num_tris)
        t = torch.where(valid, t, t.new_tensor(NO_HIT))
        tbest = t.min(dim=0).values
        best = torch.argmin(t, dim=0).to(torch.int32)   # the first minimum
        if not want_bary:
            return tbest, best
        idx = best.long()[None, :]
        bs0 = torch.gather(s0, 0, idx)[0]
        bs1 = torch.gather(s1, 0, idx)[0]
        bs2 = torch.gather(s2, 0, idx)[0]
        denom = bs0 + bs1 + bs2
        denom = torch.where(denom.abs() > 1e-30, denom,
                            denom.new_tensor(1e-30))
        return tbest, best, bs2 / denom, bs0 / denom

    def occluded(self, org, direction, tmin, tmax):
        t, _ = self.intersect(org, direction, tmin, tmax)
        return t < 1e29
