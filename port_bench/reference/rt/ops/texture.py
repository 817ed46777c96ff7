"""Frozen copy of rene_tpu_torch/ops/texture.py at commit ed2dcef.

Per-hit textures, the textured background and the env-map sampler of
the path kernels (slice K1b): the plain versions, functions on tensors.

Counterparts in rene_tpu/integrators/pallas_path.py: `_rgb9e5_dec`
(:1775), `fetch_image` (:1797; the same fetch as
rene_tpu/ops/texture.py:27 `sample_image`), `atan2_approx` (:1918),
`sphere_uv_of` (:1938), the checker of `_apply_rec_texs` (:2725-2730),
`_remap_rough_k` (:4164), `apply_images` (:4171) and the env strategy
`_mcdf_search` / `_ccdf_search` / `env_strategy` / `env_pdf_dir`
(:1967-2050). csrc/texture.cuh holds the same functions per thread.

The TPU kernel fetches a texel by sweeping 8-row pages of a VMEM atlas
with lane gathers and select chains, and searches its CDFs through
broadcast rows, because Mosaic has no per-lane gather. What it computes
is a gather: here the atlas is one flat array of RGB9E5 words, the images
back to back, and a lane reads its four texels by index; the CDF searches
are lower-bound binary searches with the reference's step sequence and
clamps.

torch's CPU uint32 has no shifts, so the packed words travel as int32
bit patterns and are decoded in int64 masked to 32 bits.

The XLA engine's texture table follows at the end (rene_tpu/ops/
texture.py: `sample_image`, `tex_color` with its one level of non-
recursive dispatch): it reads the float atlas `img_atlasT` and the
texture table as they come from build_device_scene, and takes every
texture class, a checker of image maps included.
"""
from __future__ import annotations

import math

import torch

from ..scene import pack as P
from ..scene import types as T
from ..scene.device import ENV_GH, ENV_GW
from . import vec3 as v3
from .gather import at, take
from .vec3 import V3, normalize3

TWO_PI = 2.0 * math.pi
# texels fetched so far (four per active lane and fetch; reset by the
# caller): chip_smoke.py reads it for the kernels' byte bounds
counts = {"texels": 0}
# the fetches of apply_textures and background, recorded where a list
# (set by the caller, for the texture-fetch probe, rene_tpu_torch.probe):
# each fetch appends the (N, TEXP_W + 1) rows of its active lanes, the
# image's texel offset, width and height, u, v (the probe's rows,
# kernels.tex_probe), then the fetch's kind: its slot class
# (P.IMG_CLASSES order) or N_TEX_CLASSES for the background
fetch_log = None
TEXP_W = 5


def _log_fetches(kind, off, w, h, u, v, active):
    z = torch.zeros_like(u)
    rows = torch.stack((z + off, z + w, z + h, u, v, z + kind), 1)
    fetch_log.append(rows[active])


def fetch_rows_ref(atlas: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the texture-fetch probe (kernels.tex_probe): the
    (n, 3) float32 rgb of each (n, TEXP_W) row's fetch (`fetch_image` of
    the flat `atlas`)."""
    r = rows.unbind(1)
    return torch.stack(fetch_image(atlas, *r), 1)


def rgb9e5_decode(words: torch.Tensor):
    """(r, g, b) float32 of RGB9E5 words (int32 bit patterns or any
    integer dtype holding them): m * 2^(e - 24) per channel, exact."""
    u = words.to(torch.int64) & 0xFFFFFFFF
    # 2^(e - 24) built from its exponent bits
    scale = (((u >> 27) & 31) + 103 << 23).to(torch.int32).view(
        torch.float32)
    return tuple(((u >> s) & 511).to(torch.float32) * scale
                 for s in (0, 9, 18))


def _wrap(a, m):
    m = torch.clamp_min(m, 1.0)
    return a - torch.floor(a / m) * m


def fetch_image(atlas: torch.Tensor, off, wf, hf, u, v, active=None):
    """Bilinear REPEAT fetch of (r, g, b) at (u, v), v flipped, from the
    image of `wf` x `hf` texels whose first texel is word `off` of the
    flat RGB9E5 `atlas`. `off`, `wf` and `hf` are per-lane float32 (one
    call serves lanes on different images) or python numbers. Lanes
    outside `active` read texel 0 of the atlas and return its colour.
    The texel index is computed in float32 as `yy * wf + xx`, as the
    reference computes it, so both pick the same four texels."""
    wf = torch.as_tensor(wf, dtype=torch.float32, device=u.device)
    hf = torch.as_tensor(hf, dtype=torch.float32, device=u.device)
    x = u * wf - 0.5
    y = (1.0 - v) * hf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xs = (_wrap(x0, wf), _wrap(x0 + 1.0, wf))
    ys = (_wrap(y0, hf), _wrap(y0 + 1.0, hf))
    off = torch.as_tensor(off, dtype=torch.float32, device=u.device).long()
    last = torch.clamp_min((wf * hf).long() - 1, 0)
    corners = []
    for yy, xx in ((ys[0], xs[0]), (ys[0], xs[1]),
                   (ys[1], xs[0]), (ys[1], xs[1])):
        # a uv that is not finite reads a texel of its own image
        flat = torch.nan_to_num(yy * wf + xx, nan=0.0, posinf=0.0,
                                neginf=0.0).long()
        idx = off + torch.minimum(flat.clamp_min(0), last)
        if active is not None:
            idx = torch.where(active, idx, 0)
        corners.append(rgb9e5_decode(atlas[idx]))
    counts["texels"] += 4 * int(u.numel() if active is None
                                else active.sum())
    out = []
    for ch in range(3):
        c00, c10, c01, c11 = (c[ch] for c in corners)
        t = c00 * (1.0 - fx) + c10 * fx
        b = c01 * (1.0 - fx) + c11 * fx
        out.append(t * (1.0 - fy) + b * fy)
    return tuple(out)


def checker(u, v, us, vs):
    """True on the even squares of a checkerboard of `us` x `vs` squares
    per unit uv (pallas_path.py:2725-2728)."""
    xs = u * us
    ys = v * vs
    return ((xs - 2.0 * torch.floor(0.5 * xs) < 1.0)
            == (ys - 2.0 * torch.floor(0.5 * ys) < 1.0))


def atan2_approx(y, x):
    """atan2 by octant reduction and the Cephes atanf polynomial on
    [0, tan(pi / 8)], as the reference kernel computes it (its chip has
    no atan2): uv and env cells must fall where the reference's fall."""
    ax_ = torch.abs(x)
    ay_ = torch.abs(y)
    swap = ay_ > ax_
    num = torch.minimum(ax_, ay_)
    den = torch.clamp_min(torch.maximum(ax_, ay_), 1e-30)
    t = num / den
    hi = t > 0.41421356237
    t = torch.where(hi, (t - 1.0) / (t + 1.0), t)
    z = t * t
    w = ((8.05374449538e-2 * z - 1.38776856032e-1) * z
         + 1.99777106478e-1) * z - 3.33329491539e-1
    a = w * z * t + t
    a = a + torch.where(hi, math.pi / 4.0, 0.0)
    a = torch.where(swap, math.pi / 2.0 - a, a)
    a = torch.where(x < 0.0, math.pi - a, a)
    return torch.where(y < 0.0, -a, a)


def sphere_uv_of(lx, ly, lz):
    """Spherical (u, v) of a direction or a unit-sphere local point:
    u = phi / 2 pi, v = 1 - theta / pi (pallas_path.py:1938)."""
    nx, ny, nz = normalize3(lx, ly, lz)
    theta = atan2_approx(torch.sqrt(torch.clamp_min(1.0 - nz * nz, 0.0)), nz)
    phi = atan2_approx(ny, nx)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    return phi * (0.5 / math.pi), (theta - math.pi) * (-1.0 / math.pi)


def remap_rough(r):
    """pbrt's roughness -> alpha polynomial, per hit (for an imagemap
    roughness with `remaproughness`)."""
    x = torch.log(torch.clamp_min(r, 1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x
            + 0.0171201 * x ** 3 + 0.000640711 * x ** 4)


# -- per-hit material textures -------------------------------------------------
# the attribute keys each class of P.IMG_CLASSES writes
_CLASS_KEYS = {"kd": ("abr", "abg", "abb"), "ks": ("kr", "kg", "kb"),
               "ru": ("ax",), "rv": ("ay",),
               "op": ("opr", "opg", "opb"),
               "kr": ("krr", "krg", "krb"), "kt": ("ktr", "ktg", "ktb")}


def apply_textures(tabs, attr, mat_id, hit, u, v):
    """The hit's material attributes with its textured slots evaluated at
    (u, v): first every checker slot (`_apply_rec_texs`: the even or odd
    value replaces the attribute; a checker opacity v sets op = 1 - v and
    multiplies Kr and Kt), then every image slot in P.IMG_CLASSES order
    (`apply_images`: the fetch multiplies the attribute, roughness
    remapped per hit where the material asks, opacity as above)."""
    rows = tabs["mats"][mat_id]
    attr = dict(attr)

    def desc(cls):
        o = P.MAT_TEX + P.IMG_CLASSES.index(cls) * P.TEXD_W
        return rows[:, o + P.TEXD_KIND], rows[:, o:o + P.TEXD_W]

    def apply_op(sel, val):
        for ch, (okey, kr, kt) in enumerate(zip(
                _CLASS_KEYS["op"], _CLASS_KEYS["kr"], _CLASS_KEYS["kt"])):
            attr[okey] = torch.where(sel, 1.0 - val[ch], attr[okey])
            attr[kr] = torch.where(sel, attr[kr] * val[ch], attr[kr])
            attr[kt] = torch.where(sel, attr[kt] * val[ch], attr[kt])

    for cls in ("kd", "ks", "ru", "rv", "kr", "kt", "op"):
        kind, d = desc(cls)
        sel = hit & (kind == float(P.TEXK_CHECKER))
        if not bool(sel.any()):
            continue
        even = checker(u, v, d[:, P.TEXD_US], d[:, P.TEXD_VS])
        val = [torch.where(even, d[:, P.TEXD_EVEN + ch],
                           d[:, P.TEXD_ODD + ch]) for ch in range(3)]
        if cls == "op":
            apply_op(sel, val)
            continue
        for ch, key in enumerate(_CLASS_KEYS[cls]):
            attr[key] = torch.where(sel, val[ch], attr[key])

    for cls in P.IMG_CLASSES:
        kind, d = desc(cls)
        sel = hit & (kind == float(P.TEXK_IMAGE))
        if not bool(sel.any()):
            continue
        if fetch_log is not None:
            _log_fetches(P.IMG_CLASSES.index(cls), d[:, P.TEXD_OFF],
                         d[:, P.TEXD_IW], d[:, P.TEXD_IH], u, v, sel)
        iv = fetch_image(tabs["atlas"], d[:, P.TEXD_OFF], d[:, P.TEXD_IW],
                         d[:, P.TEXD_IH], u, v, sel)
        if cls == "op":
            apply_op(sel, iv)
        elif cls in ("ru", "rv"):
            key = _CLASS_KEYS[cls][0]
            r = attr[key] * iv[0]
            r = torch.where(rows[:, P.MAT_RRM] > 0.5, remap_rough(r), r)
            attr[key] = torch.where(sel, r, attr[key])
        else:
            for ch, key in enumerate(_CLASS_KEYS[cls]):
                attr[key] = torch.where(sel, attr[key] * iv[ch], attr[key])
    return attr


# -- background ------------------------------------------------------------------
def _rot(m, x, y, z):
    """(x, y, z) through the row-major 3x3 `m` (nine python floats)."""
    return (m[0] * x + m[1] * y + m[2] * z,
            m[3] * x + m[4] * y + m[5] * z,
            m[6] * x + m[7] * y + m[8] * z)


def background(tabs, dx, dy, dz, miss):
    """Miss radiance (r, g, b) along direction d, per lane: the constant
    `CAM_BG`, times the env image or the checker at the spherical uv of
    background_matrix d when the background is textured
    (`apply_images` :4223-4264)."""
    cam = tabs["cam_f"]
    bg = cam[P.CAM_BG:P.CAM_BG + 3]
    kind = tabs["bg_kind"]
    if kind == P.BG_CONST:
        return bg
    bu, bv = sphere_uv_of(*_rot(cam[P.CAM_BG_MAT:P.CAM_BG_MAT + 9],
                                dx, dy, dz))
    if kind == P.BG_IMAGE:
        off, w, h = cam[P.CAM_BG_IMG:P.CAM_BG_IMG + 3]
        if fetch_log is not None:
            _log_fetches(P.N_TEX_CLASSES, off, w, h, bu, bv, miss)
        val = fetch_image(tabs["atlas"], off, w, h, bu, bv, miss)
    else:
        c = cam[P.CAM_BG_CHK:P.CAM_BG_CHK + 8]
        even = checker(bu, bv, c[0], c[1])
        val = [torch.where(even, c[2 + ch], c[5 + ch]) for ch in range(3)]
    return tuple(val[ch] * bg[ch] for ch in range(3))


# -- env-map importance sampling -----------------------------------------------
def _lower_bound(cdf_at, x, n: int):
    """Index of the first entry >= x among the n (a power of two) entries
    read by `cdf_at(index)`, capped at n - 1: the reference's probes
    (`lo + step - 1` for step = n/2 .. 1)."""
    lo = torch.zeros_like(x, dtype=torch.long)
    step = n >> 1
    while step:
        lo = torch.where(cdf_at(lo + (step - 1)) < x, lo + step, lo)
        step >>= 1
    return torch.clamp_max(lo, n - 1)


def env_cell(tabs, x1, x2):
    """(row, column) of the env grid cell the draws x1, x2 select."""
    mcdf, ccdf = tabs["env_mcdf"], tabs["env_ccdf"].reshape(-1)
    r = _lower_bound(lambda i: mcdf[i], x1, ENV_GH)
    cc = _lower_bound(lambda i: ccdf[r * ENV_GW + i], x2, ENV_GW)
    return r, cc


def env_strategy(tabs, x1, x2, x3, x4):
    """A world direction drawn from the env grid distribution: the cell
    from (x1, x2), a uniform point in it from (x3, x4), then through the
    inverse background matrix."""
    r, cc = env_cell(tabs, x1, x2)
    theta = (r.to(torch.float32) + x3) * (math.pi / ENV_GH)
    phi = (cc.to(torch.float32) + x4) * (TWO_PI / ENV_GW)
    stn = torch.sin(theta)
    m = tabs["cam_f"][P.CAM_BG_INV:P.CAM_BG_INV + 9]
    return normalize3(*_rot(m, stn * torch.cos(phi), stn * torch.sin(phi),
                            torch.cos(theta)))


def env_dir_cell(tabs, wx, wy, wz):
    """(row, column) of the env grid cell that world direction w falls
    in."""
    m = tabs["cam_f"][P.CAM_BG_MAT:P.CAM_BG_MAT + 9]
    dlx, dly, dlz = normalize3(*_rot(m, wx, wy, wz))
    theta = atan2_approx(torch.sqrt(torch.clamp_min(1.0 - dlz * dlz, 0.0)),
                         dlz)
    phi = atan2_approx(dly, dlx)
    phi = torch.where(phi < 0.0, phi + TWO_PI, phi)
    r = torch.clamp((theta * (ENV_GH / math.pi)).to(torch.int32), 0,
                    ENV_GH - 1).long()
    cc = torch.clamp((phi * (ENV_GW / TWO_PI)).to(torch.int32), 0,
                     ENV_GW - 1).long()
    return r, cc


def env_pdf_dir(tabs, wx, wy, wz):
    """Solid-angle pdf with which `env_strategy` draws direction w."""
    r, cc = env_dir_cell(tabs, wx, wy, wz)
    return tabs["env_pdf"].reshape(-1)[r * ENV_GW + cc]


# -- the XLA engine's texture table (rene_tpu/ops/texture.py) ---------------

def _fract(x):
    return x - torch.floor(x)


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """x.astype(int32) as XLA converts: toward zero, NaN to 0, saturated
    at the int32 range; an int64 tensor."""
    return x.double().nan_to_num(0.0).clamp(-2 ** 31, 2 ** 31 - 1).long()


def sample_image(buffers, img_idx, u, v) -> V3:
    """The bilinear, REPEAT-addressed fetch of image `img_idx` at (u, v),
    v flipped (texture.rs:124), from the (4, texels) atlas."""
    w = at(buffers["img_width"], img_idx).long()
    h = at(buffers["img_height"], img_idx).long()
    off = at(buffers["img_offset"], img_idx).long()
    atlas = buffers["img_atlasT"]
    x = u * w.to(torch.float32) - 0.5
    y = (1.0 - v) * h.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def texel(xi, yi) -> V3:
        xi = torch.remainder(to_i32(xi), torch.clamp_min(w, 1))
        yi = torch.remainder(to_i32(yi), torch.clamp_min(h, 1))
        px = take(atlas, off + yi * w + xi, dim=1)
        return V3(px[0], px[1], px[2])

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _tex_types(config):
    if config is None:
        return (T.TEX_SOLID, T.TEX_CHECKER, T.TEX_IMAGEMAP, T.TEX_SCALE)
    return config.tex_types


def _solid(buffers, idx) -> V3:
    tv = buffers["tex_v0T"]
    return V3(take(tv[0], idx), take(tv[1], idx), take(tv[2], idx))


def _color_non_recursive(buffers, idx, u, v, tex_types) -> V3:
    """A solid or an image map; a checker or a scale reads white
    (texture.rs:176-190)."""
    ttype = at(buffers["tex_type"], idx)
    out = v3.where(ttype == T.TEX_SOLID, _solid(buffers, idx), 1.0)
    if T.TEX_IMAGEMAP in tex_types:
        img = sample_image(buffers, at(buffers["tex_u0"], idx)[:, 0], u, v)
        out = v3.where(ttype == T.TEX_IMAGEMAP, img, out)
    return out


def tex_color(buffers, idx, uv, config=None) -> V3:
    """The full one-level texture dispatch (texture.rs:192-211) over the
    texture classes the scene holds. idx: (N,) table indices; uv: a (u,
    v) pair of (N,) tensors or an (N, 2) tensor."""
    if not isinstance(uv, tuple):
        uv = (uv[..., 0], uv[..., 1])
    u, v = uv
    tex_types = _tex_types(config)
    out = _solid(buffers, idx)
    if tex_types == (T.TEX_SOLID,):
        return out
    ttype = at(buffers["tex_type"], idx)
    sub = at(buffers["tex_u0"], idx)

    if T.TEX_IMAGEMAP in tex_types:
        img = sample_image(buffers, sub[:, 0], u, v)
        out = v3.where(ttype == T.TEX_IMAGEMAP, img, out)

    if T.TEX_CHECKER in tex_types:  # texture.rs:96-119
        tv = buffers["tex_v0T"]
        xs = u * take(tv[0], idx)
        ys = v * take(tv[1], idx)
        even = ((to_i32(xs) % 2 == 0) == (to_i32(ys) % 2 == 0))
        sub_idx = torch.where(even, sub[:, 0], sub[:, 1])
        checker_c = _color_non_recursive(buffers, sub_idx, _fract(xs),
                                         _fract(ys), tex_types)
        out = v3.where(ttype == T.TEX_CHECKER, checker_c, out)

    if T.TEX_SCALE in tex_types:
        scale = (_color_non_recursive(buffers, sub[:, 0], u, v, tex_types)
                 * _color_non_recursive(buffers, sub[:, 1], u, v,
                                        tex_types))
        out = v3.where(ttype == T.TEX_SCALE, scale, out)
    return out
