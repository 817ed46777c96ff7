"""Component-wise 3-vector helpers (pallas_path.py:1722-1727, :3505-3527).

Vectors are tuples of (N,) tensors, as in the megakernel.
"""
from __future__ import annotations

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
