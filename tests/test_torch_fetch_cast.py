"""The texture fetch, the env-map search and the immediates cast of the
path kernels (K1b, K1a: csrc/texture.cuh, csrc/intersect.cuh), checked on
the CPU with g++.

* The fetch (through the texture-fetch probe csrc/tex_launch.cuh)
  against the plain fetch (ops/texture.py `fetch_image`), bit for bit:
  random uv, both seams, negative and non-finite uv, 1 x 1, odd-sized
  and non-square images back to back.
* The env-map search through the guide tables (`guided_search`,
  scene/pack.py `env_guides`) against the reference's lower-bound search
  on every cdf value and its float neighbours, a dense grid of [0, 1],
  flat cdfs (rows of zero mass) and the capped last entry.
* The reuse of a fetch: a material whose two classes name one image gives
  what two fetches give.
* The immediates cast from the cast rows (`imm_rows`) against plain
  ops/intersect.py, bit for bit (t, row, normal, any-hit flag, emitter
  pdf), on recorded rays of three scenes; an exact tie keeps the first
  triangle in loop order.
* The cast rows' packing and their shared-memory budget, and the
  counting builds and probes, which take only their own tables on the
  CPU and count on a card (`cuda`).
"""
import ctypes

import numpy as np
import pytest
import torch

from rene_tpu_torch import kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.ops import intersect as X
from rene_tpu_torch.ops import rgb9e5
from rene_tpu_torch.ops import texture as TX
from rene_tpu_torch.scene import pack as P
from .test_torch_mega_path import _buffers
from .test_torch_texture import textured_buffers

torch.set_num_threads(2)

HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
#pragma GCC diagnostic ignored "-Wunused-function"
#include "cast_launch.cuh"
#include "tex_launch.cuh"
// the texture-fetch probe: the rows one after another
static int run_fetches(const uint32_t* atlas, const float* rows, int n,
                       float* out, void*) {
  for (int i = 0; i < n; ++i)
    fetch_row(atlas, rows + (size_t)i * TEXP_W, out + (size_t)i * TEXP_OUT_W);
  return 0;
}
// the immediates cast of each ray (RAY_W rows): closest rays give t, the
// part and row, the normal and the emitter pdf along them; shadow rays
// their any-hit flag
#define IMM_OUT_W 8
static int run_casts(const Scene& s, const float* rays, int n, float* out,
                     void*) {
  for (int i = 0; i < n; ++i) {
    const float* r = rays + (size_t)i * RAY_W;
    float* q = out + (size_t)i * IMM_OUT_W;
    const V3 o = v3(r[0], r[1], r[2]), d = v3(r[3], r[4], r[5]);
    for (int k = 0; k < IMM_OUT_W; ++k) q[k] = 0.f;
    if ((int)r[8] == CAST_SHADOW) {
      q[6] = shadow_any<false>(s, (int)r[9], o, d, r[6], r[7]) ? 1.f : 0.f;
      continue;
    }
    const Hit h = trace_closest<false>(s, o, d, r[6]);
    q[0] = h.t;
    q[1] = (float)h.part;
    q[2] = (float)h.row;
    q[3] = h.n.x;
    q[4] = h.n.y;
    q[5] = h.n.z;
    q[7] = trace_emit_pdf(s, o, d);
  }
  return 0;
}
// guided_search over the n-entry cdf with its guide row, for each x
extern "C" void guided_all(const float* cdf, int n, const uint8_t* guide,
                           const float* x, int m, int* out) {
  for (int i = 0; i < m; ++i) out[i] = guided_search(cdf, n, guide, x[i]);
}
// apply_textures of material row `row` at each (u, v): the material's
// roughness pair (ax, ay) and albedo
extern "C" void apply_all(const float* row, const int* atlas, const float* u,
                          const float* v, int m, float* out) {
  for (int i = 0; i < m; ++i) {
    Mat mt = load_mat(row, 0);
    apply_textures(row, (const uint32_t*)atlas, mt, u[i], v[i]);
    out[5 * i] = mt.ax;
    out[5 * i + 1] = mt.ay;
    for (int c = 0; c < 3; ++c) out[5 * i + 2 + c] = mt.ab[c];
  }
}
"""
IMM_OUT_W = 8


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    from .test_torch_kernel_source import _gxx
    lib = _gxx(tmp_path_factory, "fetch_cast", HARNESS)
    lib.tex_probe_launch.argtypes = kernels.TEX_PROBE_ARGTYPES
    lib.tex_probe_launch.restype = ctypes.c_int
    lib.cast_probe_launch.argtypes = kernels.CAST_ARGTYPES
    lib.cast_probe_launch.restype = ctypes.c_int
    _P, _I = ctypes.c_void_p, ctypes.c_int
    lib.guided_all.argtypes = [_P, _I, _P, _P, _I, _P]
    lib.apply_all.argtypes = [_P, _P, _P, _P, _I, _P]
    return lib


def _ptr(a):
    return a.ctypes.data if isinstance(a, np.ndarray) else a.data_ptr()


# -- the fetch -------------------------------------------------------------------
SHAPES = [(8, 16), (5, 3), (1, 1), (32, 32), (7, 64), (13, 9), (1, 6),
          (6, 1)]   # (h, w): odd-sized, non-square, 1 x 1, one row, one column


def _images(g):
    words = np.concatenate([rgb9e5.encode(g.uniform(0.0, 4.0, (h * w, 3))
                                          .astype(np.float32))
                            for h, w in SHAPES]).astype(np.uint32)
    offs = np.cumsum([0] + [h * w for h, w in SHAPES])[:-1]
    return words, offs


def _uv(g, case, n):
    if case == "random":
        return (g.uniform(-1.5, 2.5, n), g.uniform(-1.5, 2.5, n))
    if case == "seams":   # texel centres and edges, both seams and beyond
        u = g.integers(-40, 80, n) / 32.0
        v = g.integers(-40, 80, n) / 32.0
        edge = np.array([0.0, -0.0, 1.0, 2.0, -1.0, 1e-7, -1e-7,
                         1.0 - 1e-7, 1.0 + 1e-7, 0.5])
        u[:edge.size ** 2] = np.repeat(edge, edge.size)
        v[:edge.size ** 2] = np.tile(edge, edge.size)
        return u, v
    if case == "negative":
        return (-g.uniform(0.0, 40.0, n), -g.uniform(0.0, 40.0, n))
    # not finite, or so large that the wrap leaves the image (its flat
    # index past the image's last texel), beside finite partners
    bad = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30])
    u = g.uniform(-1.0, 2.0, n)
    v = g.uniform(-1.0, 2.0, n)
    u[::3] = bad[g.integers(0, bad.size, u[::3].size)]
    v[1::3] = bad[g.integers(0, bad.size, v[1::3].size)]
    huge = 10.0 ** g.uniform(8, 30, n) * np.where(g.uniform(0, 1, n) < 0.5,
                                                   -1, 1)
    u[2::6] = huge[2::6]
    v[5::6] = huge[5::6]
    return u, v


@pytest.mark.parametrize("case", ["random", "seams", "negative",
                                  "not_finite"])
def test_fetch_matches_plain_fetch_bit_for_bit(lib, case):
    g = np.random.default_rng(["random", "seams", "negative",
                               "not_finite"].index(case))
    words, offs = _images(g)
    n = 6000
    img = g.integers(0, len(SHAPES), n)
    u, v = _uv(g, case, n)
    rows = np.stack([offs[img], [SHAPES[i][1] for i in img],
                     [SHAPES[i][0] for i in img], u, v], 1).astype(np.float32)
    if case != "not_finite":
        assert np.isfinite(rows).all()
    atlas = torch.from_numpy(words.view(np.int32))
    ref = TX.fetch_rows_ref(atlas, torch.from_numpy(rows)).numpy()
    out = np.empty((n, 3), np.float32)
    assert lib.tex_probe_launch(_ptr(words), _ptr(rows), n, _ptr(out),
                                None) == 0
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))
    # the wrapper's plain version on CPU tensors is the same fetch
    np.testing.assert_array_equal(
        kernels.tex_probe({"atlas": atlas}, torch.from_numpy(rows)).numpy(),
        ref)


# -- the env-map search through guide tables ------------------------------------
def _lower_bound(cdf, x):
    """The reference's probes (`lo + step - 1` for step = n / 2 .. 1) in
    numpy float32: the first entry >= x, capped at n - 1."""
    lo = np.zeros(x.shape, np.int64)
    step = cdf.size // 2
    while step:
        lo = np.where(cdf[lo + step - 1] < x, lo + step, lo)
        step //= 2
    return lo


def _cdfs(g):
    """Marginal and conditional cdfs: a real env map's, random ones, flat
    ones (rows of zero mass), one whose last entry stays below 1."""
    out = []
    for n in (P.ENV_GH, P.ENV_GW):
        p = g.exponential(1.0, n) * (g.uniform(0, 1, n) < 0.3)
        p[g.integers(0, n)] += 1e-3
        out.append(np.cumsum(p / p.sum()).astype(np.float32))
        out.append(np.zeros(n, np.float32))          # zero mass
        out.append(np.full(n, 1.0, np.float32))      # all mass at 0
        flat = np.cumsum(np.r_[np.zeros(n // 2), np.ones(n // 2)])
        out.append((flat / flat[-1]).astype(np.float32))
        out.append((np.linspace(0.5, 0.9, n)).astype(np.float32))  # cap
        peak = np.full(n, 1e-9)
        peak[n // 3] = 1.0
        out.append(np.cumsum(peak / peak.sum()).astype(np.float32))
    return out


def _env_cdfs(tmp_path):
    bn, cfg = textured_buffers("env", tmp_path)
    tb = P.pack_tables(bn, cfg)
    assert tb.has_env
    return [tb.env_mcdf] + list(tb.env_ccdf), tb


@pytest.mark.parametrize("kind", ["cdf_values", "grid"])
def test_guided_search_equals_lower_bound(lib, tmp_path, kind):
    g = np.random.default_rng(3)
    env, _ = _env_cdfs(tmp_path)
    for cdf in env[:9] + _cdfs(g):
        cdf = np.ascontiguousarray(cdf, np.float32)
        guide = P.env_guides(cdf, np.zeros((0, cdf.size), np.float32))[0]
        if kind == "cdf_values":   # every value and its float neighbours
            x = np.concatenate([cdf, np.nextafter(cdf, np.float32(-1)),
                                np.nextafter(cdf, np.float32(2))])
        else:   # a dense grid of [0, 1], the ends, outside, NaN
            x = np.concatenate([np.linspace(0, 1, 20001, dtype=np.float32),
                                np.float32([0, -0.0, 1, 1.5, -0.5, np.inf,
                                            -np.inf, np.nan, 1e-45])])
        x = x.astype(np.float32)
        out = np.empty(x.size, np.int32)
        lib.guided_all(_ptr(cdf), cdf.size, _ptr(guide), _ptr(x), x.size,
                       _ptr(out))
        np.testing.assert_array_equal(out, _lower_bound(cdf, x))
    # the plain version's search (ops/texture.py) is the same function
    x = np.linspace(-0.1, 1.1, 4097).astype(np.float32)
    cdf = env[0]
    got = TX._lower_bound(lambda i: torch.from_numpy(cdf)[i],
                          torch.from_numpy(x), cdf.size)
    np.testing.assert_array_equal(got.numpy(), _lower_bound(cdf, x))


def test_env_guides_of_a_scene(tmp_path):
    """The scene's guide table: row 0 the marginal's, row 1 + r the
    conditional row r's; entry b the first index whose value is >= b /
    ENV_GUIDE (capped at the last index)."""
    _, tb = _env_cdfs(tmp_path)
    assert tb.env_guide.shape == (1 + P.ENV_GH, P.ENV_GUIDE)
    assert tb.env_guide.dtype == np.uint8
    keys = (np.arange(P.ENV_GUIDE) / P.ENV_GUIDE).astype(np.float32)
    for i, cdf in enumerate([tb.env_mcdf] + list(tb.env_ccdf)):
        want = _lower_bound(np.asarray(cdf, np.float32), keys)
        first = [int(np.argmax(cdf >= k)) if (cdf >= k).any()
                 else cdf.size - 1 for k in keys]
        np.testing.assert_array_equal(tb.env_guide[i], first)
        np.testing.assert_array_equal(tb.env_guide[i], want)


# -- the reuse of a fetch ------------------------------------------------------
def _textured_mesh_tables(tmp_path):
    d = tmp_path / "tm"
    d.mkdir()
    src = scenes.textured_mesh_scene(str(d), 32, 16, small=True)
    (d / "s.pbrt").write_text(src)
    from rene_tpu_torch.scene import build_device_scene, load_scene
    return P.pack_tables(*build_device_scene(load_scene(str(d / "s.pbrt"))))


def test_repeated_image_reuses_its_fetch(lib, tmp_path):
    """The textured mesh's balls bind one image to uroughness and
    vroughness: the host marks the second class, and the kernel's one
    fetch gives what two fetches give, bit for bit."""
    tb = _textured_mesh_tables(tmp_path)
    cls = {c: P.MAT_TEX + P.IMG_CLASSES.index(c) * P.TEXD_W
           for c in P.IMG_CLASSES}
    rows = [r for r in tb.mats
            if r[cls["ru"] + P.TEXD_KIND] == P.TEXK_IMAGE
            and r[cls["rv"] + P.TEXD_KIND] == P.TEXK_IMAGE]
    assert rows
    row = np.ascontiguousarray(rows[0], np.float32)
    assert row[cls["rv"] + P.TEXD_SAME] == 1.0
    assert row[cls["ru"] + P.TEXD_SAME] == 0.0
    assert tuple(row[cls["ru"] + 1:cls["ru"] + 4]) \
        == tuple(row[cls["rv"] + 1:cls["rv"] + 4])
    twice = row.copy()
    twice[cls["rv"] + P.TEXD_SAME] = 0.0   # fetch it again
    g = np.random.default_rng(4)
    n = 2000
    u = g.uniform(-1, 2, n).astype(np.float32)
    v = g.uniform(-1, 2, n).astype(np.float32)
    atlas = tb.atlas.view(np.int32)
    a = np.empty((n, 5), np.float32)
    b = np.empty((n, 5), np.float32)
    lib.apply_all(_ptr(row), _ptr(atlas), _ptr(u), _ptr(v), n, _ptr(a))
    lib.apply_all(_ptr(twice), _ptr(atlas), _ptr(u), _ptr(v), n, _ptr(b))
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert len(np.unique(a[:, 0])) > n // 4   # the image varies with uv
    # only a class whose image is the previous image class's is marked
    for r in tb.mats:
        prev = None
        for c in P.IMG_CLASSES:
            o = cls[c]
            if r[o + P.TEXD_KIND] != P.TEXK_IMAGE:
                assert r[o + P.TEXD_SAME] == 0.0 \
                    or r[o + P.TEXD_KIND] == P.TEXK_CHECKER
                continue
            assert r[o + P.TEXD_SAME] == float(prev == r[o + P.TEXD_OFF])
            prev = r[o + P.TEXD_OFF]


# -- the immediates cast -------------------------------------------------------
def _imm_tables(name):
    """The tables of scene `name` at 32x64, its immediates alone (the
    sphere table of sphere_light_scene left out, which the mesh builds
    walk after the immediates)."""
    bn, cfg = _buffers(name, 32)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    if tabs["has_accel"]:
        tabs = dict(tabs, has_accel=False, top=-1, block_seed=False, **{
            k: tabs[k][:0] for k in ("nodes", "sph_tab", "sph_box",
                                     "wnodes", "mesh", "mesh_vt", "insts")})
    return tabs


def _record(tabs, seed=5):
    X.ray_log = []
    try:
        M.path_lanes_ref(dict(tabs, max_depth=4), seed, 1)
        return torch.cat(X.ray_log)
    finally:
        X.ray_log = None


def cast_imm(lib, tabs, rays):
    out = torch.empty((rays.shape[0], IMM_OUT_W))
    sa = kernels.scene_args(tabs, False, rays.device)
    n_tab = kernels.CAST_TABLES
    args = sa[:n_tab] + (sa[n_tab], sa[n_tab + 8], sa[n_tab + 9],
                         rays.data_ptr(), rays.shape[0], out.data_ptr())
    assert lib.cast_probe_launch(*args, None) == 0
    return out


def plain_imm(tabs, rays):
    out = torch.zeros((rays.shape[0], IMM_OUT_W))
    closest = rays[:, 8] == X.CAST_CLOSEST
    r = rays[closest]
    ids = {}
    t, _, nx, ny, nz = X.closest(tabs, *r[:, :6].unbind(1), r[0, 6].item(),
                                 ids=ids)[:5]
    out[closest] = torch.stack(
        (t, ids["part"].float(), ids["row"].float(), nx, ny, nz,
         torch.zeros_like(t), X.emit_pdf(tabs, *r[:, :6].unbind(1))), 1)
    for li in rays[~closest, 9].unique().long().tolist():
        sel = (~closest) & (rays[:, 9] == li)
        r = rays[sel]
        out[sel, 6] = X.shadow_any(tabs, li, *r[:, :6].unbind(1),
                                   r[0, 6].item(), r[0, 7].item()).float()
    return out


@pytest.mark.parametrize("name", ["cornell_box", "materials_scene",
                                  "sphere_light_scene"])
def test_immediates_cast_matches_plain(lib, name):
    tabs = _imm_tables(name)
    rays = _record(tabs)
    closest = rays[:, 8] == X.CAST_CLOSEST
    assert closest.sum() > 500
    got, ref = cast_imm(lib, tabs, rays), plain_imm(tabs, rays)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    hit = ref[closest, 1] >= 0
    assert hit.float().mean() > 0.3
    if name != "cornell_box":
        assert (~closest).sum() > 100 or tabs["lights"].shape[0] == 0
    assert (ref[closest, 7] > 0).any()   # rays that reach an emitter


def test_immediates_cast_keeps_the_first_of_a_tie(lib):
    """Every triangle twice, the copy after the original: the closest
    hit is the original, in the g++ build and in plain, whatever order
    the rays come in."""
    tabs = _imm_tables("cornell_box")
    rays = _record(tabs)
    rays = rays[rays[:, 8] == X.CAST_CLOSEST]
    n = tabs["tris"].shape[0]
    tris = torch.cat([tabs["tris"], tabs["tris"]])
    twice = dict(tabs, tris=tris, light_dots=torch.cat(
        [tabs["light_dots"]] * 2, 1), imm=torch.from_numpy(P.imm_rows(
            tris.numpy(), tabs["spheres"].numpy())))
    got, ref = cast_imm(lib, twice, rays), plain_imm(twice, rays)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    rows = got[:, 2][got[:, 1] >= 0]
    assert rows.numel() > 500 and bool((rows < n).all())
    back = torch.flip(rays, [0])
    assert torch.equal(cast_imm(lib, twice, back), torch.flip(got, [0]))


def test_cast_rows_copy_their_fields():
    tabs = _imm_tables("materials_scene")
    tris, sph = tabs["tris"].numpy(), tabs["spheres"].numpy()
    rows = P.imm_rows(tris, sph)
    assert rows.dtype == np.float32
    assert rows.size == tris.shape[0] * P.IMM_TRI_W \
        + sph.shape[0] * P.IMM_SPH_W
    t = rows[:tris.shape[0] * P.IMM_TRI_W].reshape(-1, P.IMM_TRI_W)
    for dst, src, n in ((P.IMM_PN, P.TRI_PN, 3), (P.IMM_PK, P.TRI_PK, 1),
                        (P.IMM_M0, P.TRI_M0, 3), (P.IMM_E0, P.TRI_E0, 3),
                        (P.IMM_M1, P.TRI_M1, 3), (P.IMM_E1, P.TRI_E1, 3),
                        (P.IMM_M2, P.TRI_M2, 3), (P.IMM_E2, P.TRI_E2, 3)):
        np.testing.assert_array_equal(t[:, dst:dst + n], tris[:, src:src + n])
    assert (t[:, P.IMM_E2 + 3:] == 0).all()   # the padding
    s = rows[tris.shape[0] * P.IMM_TRI_W:].reshape(-1, P.IMM_SPH_W)
    np.testing.assert_array_equal(s, sph[:, P.SPH_W2O:P.SPH_W2O + 12])
    assert P.IMM_TRI_W % 4 == 0 and P.IMM_SPH_W % 4 == 0   # float4 rows
    np.testing.assert_array_equal(tabs["imm"].numpy(), rows)


def test_cast_rows_at_the_caps_fit_shared_memory():
    """A scene at the immediates caps (512 triangles, 64 spheres) fits
    the budget, which fits a block of the card; past it the tables are
    refused with a message that names the caps."""
    tabs = _imm_tables("materials_scene")
    assert kernels.IMM_SMEM_MAX <= kernels.SMEM_PER_BLOCK

    def at(n_tri, n_sph):
        tris = tabs["tris"][torch.arange(n_tri) % tabs["tris"].shape[0]]
        sph = tabs["spheres"][torch.arange(n_sph) % tabs["spheres"].shape[0]]
        return dict(tabs, tris=tris, spheres=sph, light_dots=torch.zeros(
            (tabs["lights"].shape[0], n_tri, 4)),
            imm=torch.from_numpy(P.imm_rows(tris.numpy(), sph.numpy())))
    full = at(P.MAX_TRIS, P.MAX_SPHERES)
    assert full["imm"].numel() * 4 == kernels.IMM_SMEM_MAX == 52224
    kernels.scene_args(full, False, torch.device("cpu"))
    with pytest.raises(ValueError, match=f"{P.MAX_TRIS} triangles"):
        kernels.scene_args(at(P.MAX_TRIS + 1, P.MAX_SPHERES), False,
                           torch.device("cpu"))


def test_texture_code_instance_follows_the_scene(tmp_path):
    """The kernels launch their instance with texture code (TEX) for a
    scene with textured materials, a textured background or env-map
    sampling, and the one without for the others; the flag is the scalar
    after has_env."""
    cornell = _imm_tables("cornell_box")
    textured = M.device_tables(_textured_mesh_tables(tmp_path), "cpu")
    bn, cfg = textured_buffers("env", tmp_path)
    env = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    no_nee = dict(env, has_env=False, **{
        k: env[k][:0] for k in ("env_mcdf", "env_ccdf", "env_pdf",
                                "env_guide")})
    assert env["has_env"] and no_nee["bg_kind"] == P.BG_IMAGE
    cpu = torch.device("cpu")
    for tabs, want in ((cornell, False), (textured, True), (env, True),
                       (no_nee, True)):
        assert kernels.runs_tex(tabs) == want
        sa = kernels.scene_args(tabs, False, cpu)
        assert sa[kernels.CAST_TABLES + 10] == int(want)
        assert sa[kernels.CAST_TABLES + 9] == int(tabs["has_env"])


# -- the counting builds and the probes -------------------------------------------
def test_counting_builds_take_card_tables_only(tmp_path):
    cornell = _imm_tables("cornell_box")
    textured = M.device_tables(_textured_mesh_tables(tmp_path), "cpu")
    for fn, tabs in ((kernels.mega_path_tex_counts, textured),
                     (kernels.mega_path_counts, cornell),
                     (kernels.mega_path_tex_counts, cornell),
                     (kernels.mega_path_counts, textured)):
        with pytest.raises(ValueError):
            fn(tabs, 1, 1)
    rays = _record(cornell)
    assert torch.equal(kernels.cast_probe(cornell, rays),
                       X.cast_ref(cornell, rays))
    assert kernels.probe_library(cornell) == "mega_path"
    assert kernels.probe_library(textured) == "mega_path_mesh"


def test_fetch_log_records_probe_rows(tmp_path):
    """The plain version's fetch log holds the probe's rows: refetched
    through the probe's plain version they give the fetches' values."""
    tabs = M.device_tables(_textured_mesh_tables(tmp_path), "cpu")
    TX.fetch_log = []
    try:
        M.path_lanes_ref(dict(tabs, max_depth=3), 5, 1)
        rows = torch.cat(TX.fetch_log)
    finally:
        TX.fetch_log = None
    kinds = rows[:, TX.TEXP_W].long()
    assert set(kinds.tolist()) >= {P.IMG_CLASSES.index("kd"),
                                   P.N_TEX_CLASSES}
    rows = rows[:, :TX.TEXP_W].contiguous()
    ref = TX.fetch_rows_ref(tabs["atlas"], rows)
    assert torch.isfinite(ref).all() and ref.shape == (rows.shape[0], 3)


@pytest.mark.cuda
def test_counting_builds_and_probes_count_on_card(tmp_path):
    """On a card: the texture and phase counts over a launch, and the
    fetch and immediates probes against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    textured = M.device_tables(_textured_mesh_tables(tmp_path), "cuda")
    _, c = kernels.mega_path_tex_counts(textured, 7, 1)
    assert c["apply_lanes"] > 0 and c["fetch_kd"] > 0
    assert c["fetch_repeat"] > 0 and c["env_draws"] > 0
    assert 0 < c["tex_cycles"] < c["lane_cycles"]
    cornell = M.device_tables(P.pack_tables(*_buffers("cornell_box", 32)),
                              "cuda")
    _, c = kernels.mega_path_counts(cornell, 7, 4)
    assert c["lanes"] == 32 * 64 and c["lane_bounces"] > c["lanes"]
    assert c["lane_bounces"] <= c["warp_bounce_slots"]
    assert 0 < c["trace_cycles"] < c["lane_cycles"]
    TX.fetch_log = []
    try:
        M.path_lanes_ref(dict(textured, max_depth=3), 5, 1)
        rows = torch.cat(TX.fetch_log)[:, :TX.TEXP_W].contiguous()
    finally:
        TX.fetch_log = None
    got = kernels.tex_probe(textured, rows)
    ref = TX.fetch_rows_ref(textured["atlas"], rows)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    rays = _record(M.device_tables(P.pack_tables(*_buffers("cornell_box",
                                                           32)), "cpu"))
    res = kernels.cast_probe(cornell, rays.cuda())
    same = (res[:, 1:] == X.cast_ref(cornell, rays.cuda())[:, 1:]).all(1)
    assert same.double().mean() >= 0.999
