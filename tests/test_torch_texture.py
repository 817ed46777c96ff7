"""Textures, textured backgrounds and env-map light sampling (slice K1b).

First the functions of rene_tpu_torch/ops/texture.py on numpy inputs from
a seed, against the reference and against numpy transcriptions of the
reference kernel's inline code (rene_tpu/integrators/pallas_path.py):

* `rgb9e5_decode` against rene_tpu.ops.rgb9e5.decode: bit for bit (every
  step is exact: a 9-bit integer times a power of two).
* `fetch_image` against a float32 numpy transcription of `fetch_image`
  (:1810-1830, :1906-1908): the same four texels, the result bit for bit;
  and against rene_tpu.ops.texture.sample_image (:27), the XLA engine's
  fetch: within 2e-6 of the largest texel. sample_image wraps the texel
  coordinate with an integer `mod` where the kernel wraps it in float32
  (`a - floor(a / m) * m`); for whole-numbered coordinates the two agree,
  also across the seam (u or v outside [0, 1)), so what is left is XLA's
  contraction of the bilinear weights.
* `checker` and `atan2_approx` against numpy transcriptions (:2725-2728,
  :1918-1936): bit for bit. `sphere_uv_of` (:1938): within 3e-7, as
  torch's rsqrt and numpy's 1 / sqrt differ in the last ulp.
* `env_strategy` and `env_pdf_dir` against numpy `searchsorted` on the
  same CDFs: equal cells, directions within 1e-6.

Then the slice as a whole: `render(device="cpu")` against
`rene_tpu.render.render(engine="pallas")`, the JAX megakernel in
interpret mode, per pixel, on `textured_scene` with every background,
`env_scene` without and with an emitter and the small
`textured_mesh_scene` (the JAX packer's clusters cut to 16, as in
test_torch_mesh.py). Both sides draw the same streams from the same chunk
seeds. Limits (PERF.md section 2): >= 99.5% of pixels' radiance (rtol
1e-3, atol 1e-5), >= 99% of their normal and albedo (1e-4), image means
within 1e-3, ray totals within 0.1%. Measured: radiance >= 99.93%, AOV >=
99.80%, means within 7.9e-5, rays within 0.03%. The wave engine's parity
on these scenes is in test_torch_texture_wave.py.
"""
import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.ops import texture as TX
from rene_tpu_torch.scene import pack as P

torch.set_num_threads(2)

# environment switches of the JAX kernel, pinned to its defaults
JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER", "RENE_IMG_PACK",
               "RENE_ENV_NEE", "RENE_ATTR_ELIDE", "RENE_MEGA_ABLATE")

TEXTURED = scenes.TEXTURED


def textured_scene(name, directory, width=0, height=0):
    """The FlatScene of scenes.TEXTURED[name], its images written to
    `directory`."""
    return create_scene(parse_pbrt(scenes.textured(name, directory, width,
                                                   height)), str(directory))


def textured_buffers(name, directory, width=0, height=0):
    return build_device_scene(textured_scene(name, directory, width, height))


def jax_env(mp):
    """Pin the JAX kernel's switches; cut its cluster widths so the
    interpret-mode compile of a mesh scene stays short."""
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)
    return pp


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# -- ops/texture.py ------------------------------------------------------------
def test_rgb9e5_decode_bit_exact():
    from rene_tpu.ops import rgb9e5
    g = np.random.default_rng(0)
    words = g.integers(0, 1 << 32, 8192, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 511, 31 << 27]
    ref = rgb9e5.decode(words)
    got = torch.stack(TX.rgb9e5_decode(_t(words.view(np.int32))), -1).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def _atlas(g, shapes):
    """Random images on the RGB9E5 grid: (float (n, 3) texels, packed
    words, offsets)."""
    from rene_tpu.ops import rgb9e5
    texels = np.concatenate([g.uniform(0.0, 4.0, (h * w, 3))
                             for h, w in shapes]).astype(np.float32)
    words = rgb9e5.encode(texels)
    offs = np.cumsum([0] + [h * w for h, w in shapes])[:-1]
    return rgb9e5.decode(words), words, offs


def _np_fetch(texels, off, wf, hf, u, v):
    """pallas_path.py:1810-1830 and :1906-1908 in numpy float32: (rgb,
    the four flat texel indices)."""
    f = np.float32
    x = u * wf - f(0.5)
    y = (f(1.0) - v) * hf - f(0.5)
    x0, y0 = np.floor(x), np.floor(y)
    fx, fy = x - x0, y - y0

    def wrap(a, m):
        m = np.maximum(m, f(1.0))
        return a - np.floor(a / m) * m

    xs = (wrap(x0, wf), wrap(x0 + f(1.0), wf))
    ys = (wrap(y0, hf), wrap(y0 + f(1.0), hf))
    idx = [(off + (yy * wf + xx)).astype(np.int64)
           for yy, xx in ((ys[0], xs[0]), (ys[0], xs[1]),
                          (ys[1], xs[0]), (ys[1], xs[1]))]
    c = [texels[i] for i in idx]
    fx, fy = fx[:, None], fy[:, None]
    top = c[0] * (f(1.0) - fx) + c[1] * fx
    bot = c[2] * (f(1.0) - fx) + c[3] * fx
    return top * (f(1.0) - fy) + bot * fy, idx


def test_fetch_image_matches_reference():
    import jax.numpy as jnp
    from rene_tpu.ops.texture import sample_image
    g = np.random.default_rng(1)
    shapes = [(8, 16), (5, 3), (1, 1), (32, 32), (7, 64)]
    texels, words, offs = _atlas(g, shapes)
    n = 8192
    img = g.integers(0, len(shapes), n)
    u = g.uniform(-1.5, 2.5, n).astype(np.float32)
    v = g.uniform(-1.5, 2.5, n).astype(np.float32)
    # texel centres and edges, where floor decides
    u[:512] = (g.integers(-8, 24, 512) / 16.0).astype(np.float32)
    v[:512] = (g.integers(-8, 24, 512) / 8.0).astype(np.float32)
    wf = np.array([s[1] for s in shapes], np.float32)[img]
    hf = np.array([s[0] for s in shapes], np.float32)[img]
    off = offs[img].astype(np.float32)
    got = torch.stack(TX.fetch_image(_t(words.view(np.int32)), _t(off),
                                     _t(wf), _t(hf), _t(u), _t(v)), -1).numpy()
    ref, idx = _np_fetch(texels, off, wf, hf, u, v)
    for i in idx:   # every index inside its own image
        assert (i >= offs[img]).all() and (i < offs[img] + wf * hf).all()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    atlas4 = np.concatenate([texels, np.ones((len(texels), 1), np.float32)], 1)
    buffers = {"img_width": jnp.asarray(wf.astype(np.int32)),
               "img_height": jnp.asarray(hf.astype(np.int32)),
               "img_offset": jnp.asarray(off.astype(np.int32)),
               "img_atlasT": jnp.asarray(np.ascontiguousarray(atlas4.T))}
    xla = sample_image(buffers, jnp.arange(n), jnp.asarray(u), jnp.asarray(v))
    xla = np.stack([np.asarray(c) for c in (xla.x, xla.y, xla.z)], -1)
    np.testing.assert_allclose(got, xla, rtol=0, atol=2e-6 * texels.max())


def test_checker_and_atan2_match_transcription():
    f = np.float32
    g = np.random.default_rng(2)
    n = 8192
    u = g.uniform(-2.0, 3.0, n).astype(f)
    v = g.uniform(-2.0, 3.0, n).astype(f)
    us = g.choice([1.0, 2.0, 3.0, 8.0, 24.0], n).astype(f)
    vs = g.choice([1.0, 4.0, 6.0, 24.0], n).astype(f)
    xs, ys = u * us, v * vs
    ref = ((xs - f(2.0) * np.floor(f(0.5) * xs) < f(1.0))
           == (ys - f(2.0) * np.floor(f(0.5) * ys) < f(1.0)))
    got = TX.checker(_t(u), _t(v), _t(us), _t(vs)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.3 < ref.mean() < 0.7

    y = g.normal(size=n).astype(f)
    x = g.normal(size=n).astype(f)
    y[:8] = [0, 0, 1, -1, 1, -1, 0, 1e-30]
    x[:8] = [1, -1, 0, 0, 1, -1, 0, 1e-30]
    ref = _np_atan2(y, x)
    got = TX.atan2_approx(_t(y), _t(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    # the polynomial is an atan2 to ~1e-6
    np.testing.assert_allclose(got[8:], np.arctan2(y[8:], x[8:]), rtol=0,
                               atol=2e-6)


def _np_atan2(y, x):
    """pallas_path.py:1918-1936 in numpy float32."""
    f = np.float32
    pi = f(np.pi)
    ax_, ay_ = np.abs(x), np.abs(y)
    swap = ay_ > ax_
    num = np.minimum(ax_, ay_)
    den = np.maximum(np.maximum(ax_, ay_), f(1e-30))
    t = num / den
    hi = t > f(0.41421356237)
    t = np.where(hi, (t - f(1.0)) / (t + f(1.0)), t)
    z = t * t
    w = ((f(8.05374449538e-2) * z - f(1.38776856032e-1)) * z
         + f(1.99777106478e-1)) * z - f(3.33329491539e-1)
    a = w * z * t + t
    a = a + np.where(hi, f(np.pi / 4.0), f(0.0))
    a = np.where(swap, f(np.pi / 2.0) - a, a)
    a = np.where(x < 0, pi - a, a)
    return np.where(y < 0, -a, a).astype(f)


def test_sphere_uv_matches_transcription():
    f = np.float32
    g = np.random.default_rng(3)
    p = g.normal(size=(8192, 3)).astype(f) * f(3.0)
    inv = f(1.0) / np.sqrt(np.maximum((p * p).sum(1, dtype=f), f(1e-20)))
    nx, ny, nz = (p * inv[:, None]).T
    theta = _np_atan2(np.sqrt(np.maximum(f(1.0) - nz * nz, f(0.0))), nz)
    phi = _np_atan2(ny, nx)
    phi = np.where(phi < 0, phi + f(2.0 * np.pi), phi)
    ref_u = phi * f(0.5 / np.pi)
    ref_v = (theta - f(np.pi)) * f(-1.0 / np.pi)
    u, v = TX.sphere_uv_of(*(_t(p[:, k]) for k in range(3)))
    np.testing.assert_allclose(u.numpy(), ref_u, rtol=0, atol=3e-7)
    np.testing.assert_allclose(v.numpy(), ref_v, rtol=0, atol=3e-7)
    assert 0.0 <= u.min() and u.max() <= 1.0 and 0.0 <= v.min() \
        and v.max() <= 1.0


def test_remap_rough_matches_host_polynomial():
    """The per-hit remap is the host's `_remap_rough` (:608), which the
    solid and checker slots go through."""
    r = np.random.default_rng(4).uniform(0.0, 1.0, 1024).astype(np.float32)
    ref = np.array([P._remap_rough(float(x)) for x in r])
    got = TX.remap_rough(_t(r)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def env_tabs(tmp_path_factory):
    d = tmp_path_factory.mktemp("env_tabs")
    bn, cfg = textured_buffers("env", d, 8, 8)
    assert cfg.env_nee
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["has_env"] and tabs["env_ccdf"].shape == (64, 128)
    return bn, tabs


def test_env_strategy_matches_searchsorted(env_tabs):
    bn, tabs = env_tabs
    g = np.random.default_rng(5)
    n = 8192
    x = g.uniform(0.0, 1.0, (4, n)).astype(np.float32)
    x[0, :64] = bn["env_mcdf"]          # draws on a CDF entry
    x[1, :128] = bn["env_ccdf"][3]
    x[0, 64:66] = [0.0, 0.99999994]
    r, cc = TX.env_cell(tabs, _t(x[0]), _t(x[1]))
    r_ref = np.minimum(np.searchsorted(bn["env_mcdf"], x[0], "left"), 63)
    cc_ref = np.array([min(np.searchsorted(bn["env_ccdf"][ri], xi, "left"),
                           127) for ri, xi in zip(r_ref, x[1])])
    np.testing.assert_array_equal(r.numpy(), r_ref)
    np.testing.assert_array_equal(cc.numpy(), cc_ref)
    # the hot window of the map (an eighth of the rows) draws a large share
    assert np.bincount(r_ref, minlength=64)[8:16].sum() > 0.3 * n
    theta = (r_ref + x[2].astype(np.float64)) * (np.pi / 64)
    phi = (cc_ref + x[3].astype(np.float64)) * (2 * np.pi / 128)
    local = np.stack([np.sin(theta) * np.cos(phi),
                      np.sin(theta) * np.sin(phi), np.cos(theta)])
    ref = bn["background_matrix_inv"].astype(np.float64)[:3, :3] @ local
    ref /= np.linalg.norm(ref, axis=0)
    got = torch.stack(TX.env_strategy(tabs, *(_t(a) for a in x))).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # a drawn direction falls back into its own cell, with that cell's pdf
    # (but for directions within float rounding of a cell's edge)
    r2, cc2 = TX.env_dir_cell(tabs, *(_t(a) for a in got))
    same = (r2.numpy() == r_ref) & (cc2.numpy() == cc_ref)
    assert same.mean() > 0.999
    pdf = TX.env_pdf_dir(tabs, *(_t(a) for a in got)).numpy()
    np.testing.assert_array_equal(pdf[same],
                                  bn["env_pdf"][r_ref[same], cc_ref[same]])


def test_env_pdf_dir_matches_numpy(env_tabs):
    bn, tabs = env_tabs
    g = np.random.default_rng(6)
    w = g.normal(size=(3, 8192))
    w = (w / np.linalg.norm(w, axis=0)).astype(np.float32)
    dl = bn["background_matrix"].astype(np.float64)[:3, :3] @ w
    dl /= np.linalg.norm(dl, axis=0)
    theta = np.arccos(np.clip(dl[2], -1, 1))
    phi = np.arctan2(dl[1], dl[0]) % (2 * np.pi)
    r = np.clip((theta * 64 / np.pi).astype(int), 0, 63)
    cc = np.clip((phi * 128 / (2 * np.pi)).astype(int), 0, 127)
    # away from cell edges, where the polynomial atan2 (~1e-6) decides
    inside = (np.abs(theta * 64 / np.pi - np.round(theta * 64 / np.pi))
              > 1e-3) & (np.abs(phi * 64 / np.pi
                                - np.round(phi * 64 / np.pi)) > 1e-3)
    assert inside.mean() > 0.99
    got = TX.env_pdf_dir(tabs, *(_t(a) for a in w)).numpy()
    np.testing.assert_array_equal(got[inside], bn["env_pdf"][r, cc][inside])


# -- the slice as a whole ------------------------------------------------------
def _check_images(out, ref, shape):
    c, rc = out["color"], ref["color"]
    assert c.shape == rc.shape == shape
    assert np.isfinite(c).all()
    rad = np.isclose(c, rc, rtol=1e-3, atol=1e-5).all(-1).mean()
    aov = min((np.abs(out[k] - ref[k]) <= 1e-4).all(-1).mean()
              for k in ("normal", "albedo"))
    mean = abs(c.mean() - rc.mean()) / abs(rc.mean())
    rays = abs(out["total_rays"] - ref["total_rays"]) / ref["total_rays"]
    assert rad >= 0.995 and aov >= 0.99 and mean <= 1e-3 and rays <= 1e-3, \
        (rad, aov, mean, rays)


@pytest.mark.parametrize("name", list(TEXTURED))
def test_render_matches_jax_pallas_engine(name, tmp_path, monkeypatch):
    from rene_tpu.render import render as jax_render
    from rene_tpu_torch.render import render
    jax_env(monkeypatch)
    w, h = TEXTURED[name][1]
    scene = textured_scene(name, tmp_path)
    bn, cfg = build_device_scene(scene)
    tabs = P.pack_tables(bn, cfg)
    assert tabs.has_tex == name.startswith("tex")
    assert tabs.has_env == (name in ("tex_image", "env", "env_emitter",
                                     "textured_mesh"))
    assert tabs.has_accel == (name == "textured_mesh")
    ref = jax_render(scene, spp=2, seed=7, engine="pallas")
    out = render(scene, spp=2, seed=7, device="cpu")
    assert out["launches"] == 0
    _check_images(out, ref, (h, w, 3))
    # the textures reach the albedo AOV
    if tabs.has_tex:
        assert out["albedo"].reshape(-1, 3).std(0).min() > 0.02
