"""Frozen copy of rene_tpu_torch/ops/vec3.py at commit ed2dcef.

Component-wise 3-vector helpers (pallas_path.py:1722-1727, :3505-3527).

Vectors are tuples of (N,) tensors, as in the megakernel. The XLA
engine's forms follow below them: `V3`, a NamedTuple of three (N,)
tensors with the vector algebra of rene_tpu/ops/vec3.py, `where`,
`coordinate_system`, `Onb`, the local-frame trigonometry, `sphere_uv`
and the `affine_*` maps.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z):
    inv = torch.rsqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20))
    return x * inv, y * inv, z * inv


def onb_from_w(nx, ny, nz):
    """(u, v) completing the frame around unit normal n."""
    x_major = torch.abs(nx) > torch.abs(ny)
    inv = torch.rsqrt(torch.clamp_min(
        torch.where(x_major, nx * nx + nz * nz, ny * ny + nz * nz), 1e-20))
    zero = torch.zeros_like(nx)
    ux = torch.where(x_major, -nz, zero) * inv
    uy = torch.where(x_major, zero, nz) * inv
    uz = torch.where(x_major, nx, -ny) * inv
    vx = ny * uz - nz * uy
    vy = nz * ux - nx * uz
    vz = nx * uy - ny * ux
    return ux, uy, uz, vx, vy, vz


def to_local(ux, uy, uz, vx, vy, vz, nx, ny, nz, ax, ay, az):
    return (ax * ux + ay * uy + az * uz,
            ax * vx + ay * vy + az * vz,
            ax * nx + ay * ny + az * nz)


def to_world(ux, uy, uz, vx, vy, vz, nx, ny, nz, ax, ay, az):
    return (ax * ux + ay * vx + az * nx,
            ax * uy + ay * vy + az * ny,
            ax * uz + ay * vz + az * nz)


# -- the XLA engine's vectors (rene_tpu/ops/vec3.py) ------------------------

class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(a):
        """(..., 3) tensor -> V3 of (...) components."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def fill(v, shape=(), device=None, dtype=torch.float32):
        c = torch.full(shape, v, dtype=dtype, device=device)
        return V3(c, c, c)

    @staticmethod
    def zeros(shape=(), device=None, dtype=torch.float32):
        return V3.fill(0.0, shape, device, dtype)

    @staticmethod
    def ones(shape=(), device=None, dtype=torch.float32):
        return V3.fill(1.0, shape, device, dtype)

    def to_array(self):
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __rtruediv__(self, o):
        return V3(o / self.x, o / self.y, o / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def dot(self, o: "V3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "V3") -> "V3":
        return V3(self.y * o.z - self.z * o.y,
                  self.z * o.x - self.x * o.z,
                  self.x * o.y - self.y * o.x)

    def length_squared(self):
        return self.dot(self)

    def length(self):
        return torch.sqrt(torch.clamp_min(self.length_squared(), 0.0))

    def normalized(self, eps=1e-20):
        inv = 1.0 / torch.clamp_min(self.length(), eps)
        return self * inv

    def abs(self) -> "V3":
        return V3(torch.abs(self.x), torch.abs(self.y), torch.abs(self.z))

    def max_component(self):
        return torch.maximum(self.x, torch.maximum(self.y, self.z))

    def sum(self):
        return self.x + self.y + self.z

    def any_nonzero(self):
        return (self.x != 0.0) | (self.y != 0.0) | (self.z != 0.0)

    def exp(self) -> "V3":
        return V3(torch.exp(self.x), torch.exp(self.y), torch.exp(self.z))

    def map(self, fn) -> "V3":
        return V3(fn(self.x), fn(self.y), fn(self.z))


def _parts(a):
    return (a.x, a.y, a.z) if isinstance(a, V3) else (a, a, a)


def where(mask, a, b) -> V3:
    """Component select; `a` and `b` are V3s or scalars."""
    return V3(*(torch.where(mask, p, q) for p, q in zip(_parts(a),
                                                        _parts(b))))


def face_forward(v: V3, ref: V3) -> V3:
    return where(v.dot(ref) < 0.0, -v, v)


def reflect(wo: V3, n: V3) -> V3:
    return -wo + n * (2.0 * wo.dot(n))


def coordinate_system(v1: V3):
    """(v2, v3) completing the frame around v1 (math.rs:89-97)."""
    x_major = torch.abs(v1.x) > torch.abs(v1.y)
    inv = 1.0 / torch.sqrt(torch.clamp_min(
        torch.where(x_major, v1.x * v1.x + v1.z * v1.z,
                    v1.y * v1.y + v1.z * v1.z), 1e-20))
    zero = torch.zeros_like(inv)
    v2 = V3(torch.where(x_major, -v1.z, zero) * inv,
            torch.where(x_major, zero, v1.z) * inv,
            torch.where(x_major, v1.x, -v1.y) * inv)
    return v2, v1.cross(v2)


class Onb(NamedTuple):
    u: V3
    v: V3
    w: V3

    @staticmethod
    def from_w(w: V3) -> "Onb":
        u, v = coordinate_system(w)
        return Onb(u, v, w)

    def to_local(self, vec: V3) -> V3:
        return V3(vec.dot(self.u), vec.dot(self.v), vec.dot(self.w))

    def to_world(self, vec: V3) -> V3:
        return self.u * vec.x + self.v * vec.y + self.w * vec.z


# local-frame trigonometry (z = normal)
def cos_theta(w: V3):
    return w.z


def cos2_theta(w: V3):
    return w.z * w.z


def abs_cos_theta(w: V3):
    return torch.abs(w.z)


def sin2_theta(w: V3):
    return torch.clamp_min(1.0 - w.z * w.z, 0.0)


def sin_theta(w: V3):
    return torch.sqrt(sin2_theta(w))


def tan_theta(w: V3):
    return sin_theta(w) / w.z


def tan2_theta(w: V3):
    return sin2_theta(w) / torch.clamp_min(cos2_theta(w), 1e-30)


def cos_phi(w: V3):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0, torch.clamp(
        w.x / torch.clamp_min(s, 1e-20), -1.0, 1.0))


def sin_phi(w: V3):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0, torch.clamp(
        w.y / torch.clamp_min(s, 1e-20), -1.0, 1.0))


def cos2_phi(w: V3):
    c = cos_phi(w)
    return c * c


def sin2_phi(w: V3):
    s = sin_phi(w)
    return s * s


def same_hemisphere(a: V3, b: V3):
    return a.z * b.z > 0.0


def sphere_uv(p: V3):
    """Unit direction -> (u, v) (math.rs:70-76)."""
    theta = torch.arccos(torch.clamp(p.z, -1.0, 1.0))
    phi = torch.atan2(p.y, p.x)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return phi * (0.5 / math.pi), (theta - math.pi) * (-1.0 / math.pi)


def affine_point(m, p: V3) -> V3:
    """One (3, 4) affine map (a tensor or nested lists) applied to V3
    points."""
    return V3(m[0][0] * p.x + m[0][1] * p.y + m[0][2] * p.z + m[0][3],
              m[1][0] * p.x + m[1][1] * p.y + m[1][2] * p.z + m[1][3],
              m[2][0] * p.x + m[2][1] * p.y + m[2][2] * p.z + m[2][3])


def affine_vector(m, v: V3) -> V3:
    return V3(m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
              m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
              m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z)


def affine_point_rows(rows, p: V3) -> V3:
    """Per-lane affine maps: rows[i][j] are (N,) tensors, i in 0..2, j in
    0..3."""
    return V3(rows[0][0] * p.x + rows[0][1] * p.y + rows[0][2] * p.z
              + rows[0][3],
              rows[1][0] * p.x + rows[1][1] * p.y + rows[1][2] * p.z
              + rows[1][3],
              rows[2][0] * p.x + rows[2][1] * p.y + rows[2][2] * p.z
              + rows[2][3])
