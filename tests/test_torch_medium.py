"""Homogeneous media of the volpath body (slice K1e): ops/medium.py and the
packed media table.

* `med_tr` and `med_phase` against rene_tpu.ops.medium (rtol 1e-6), on a
  table of seven media: vacuum, five homogeneous media with g in {0.3,
  5e-4, 0.9, -0.9, 0}, and one with no extinction in its red channel;
* `med_sample` and `med_sample_p`, whose kernel forms differ from the XLA
  forms of rene_tpu.ops.medium (the channel is floor(3 u), the frame is
  `onb_from_w`'s), against float64 numpy transcriptions of the JAX
  megakernel's (pallas_path.py:3311-3333 and :3343-3361) on the draws the
  port's streams give: vacuum lanes, the t_max clamp, the pdf == 0 guard
  and every g above;
* the mean cosine of Henyey-Greenstein sampling about the ray's direction
  equals g within 0.01 over 2^16 samples;
* the packed media table and the material slots' (interior, exterior)
  media equal `pack_scene`'s `media` records and the `imed`/`emed` of its
  primitive records on the three fog scenes.

Inputs come from seeded numpy generators.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rene_tpu.ops import medium as JM
from rene_tpu.ops.vec3 import V3
from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import scenes
from rene_tpu_torch.ops import medium as MD
from rene_tpu_torch.ops import rng
from rene_tpu_torch.scene import pack as P
from rene_tpu_torch.scene import types as T

torch.set_num_threads(2)

N = 4096
G = (0.0, 0.3, 5e-4, 0.9, -0.9, 0.0, 0.2)


def _media_buffers():
    """The medium fields of a scene's buffers: row 0 vacuum, row 6 with
    sigma_t 0 in its red channel."""
    r = np.random.default_rng(3)
    n = len(G)
    sa = r.uniform(0.01, 0.3, (n, 3)).astype(np.float32)
    ss = r.uniform(0.05, 0.9, (n, 3)).astype(np.float32)
    sa[0] = ss[0] = 0.0
    sa[6, 0] = ss[6, 0] = 0.0
    med_type = np.full(n, T.MEDIUM_HOMOGENEOUS, np.int32)
    med_type[0] = T.MEDIUM_VACUUM
    return {"med_type": med_type, "med_sigma_a": sa, "med_sigma_s": ss,
            "med_g": np.float32(G)}


@pytest.fixture(scope="module")
def media():
    bn = _media_buffers()
    return bn, torch.from_numpy(np.float32(P.media_table(bn)))


def _lanes(seed):
    """Per lane: a medium index (float), a uint32 stream state."""
    r = np.random.default_rng(seed)
    med = r.integers(0, len(G), N)
    st = r.integers(1, 2 ** 32, N, dtype=np.uint64).astype(np.int64)
    return med, torch.from_numpy(med).float(), torch.from_numpy(st)


def _draws(st, n):
    out = []
    for _ in range(n):
        u, st = rng.uniform(st)
        out.append(u.double().numpy())
    return out


def test_med_tr_matches_reference(media):
    bn, tab = media
    med, med_f, _ = _lanes(1)
    t = np.float32(np.random.default_rng(2).exponential(4.0, N))
    t[:16] = 0.0
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    one, zero = jnp.ones(N, jnp.float32), jnp.zeros(N, jnp.float32)
    ref = JM.med_tr(jb, jnp.asarray(med), V3(one, zero, zero),
                    jnp.asarray(t))
    out = MD.med_tr(tab, med_f, torch.from_numpy(t))
    for c in range(3):
        np.testing.assert_allclose(out[c].numpy(), np.asarray(ref[c]),
                                   rtol=1e-6, atol=0)
    vac = med == 0
    assert vac.any() and (out[0].numpy()[vac] == 1.0).all()


def test_med_phase_matches_reference(media):
    """wo = +x and wi = (c, s, 0): both packages see cos = c exactly."""
    bn, tab = media
    med, med_f, _ = _lanes(4)
    c = np.float32(np.random.default_rng(5).uniform(-1.0, 1.0, N))
    c[:8] = [-1.0, 1.0, 0.0, -1.0, -0.99, 0.99, -1.0, 1.0]
    s = np.sqrt(np.maximum(1.0 - c * c, 0.0)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in bn.items()}
    one, zero = jnp.ones(N, jnp.float32), jnp.zeros(N, jnp.float32)
    ref = JM.med_phase(jb, jnp.asarray(med), V3(one, zero, zero),
                       V3(jnp.asarray(c), jnp.asarray(s), zero))
    out = MD.med_phase(tab, med_f, torch.from_numpy(c))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)
    assert (out.numpy()[med == 0] == 0.0).all()


def _med_sample64(tab, med, t_max, u_ch, u):
    """pallas_path.py:3311-3333 in float64."""
    st, ss = tab[med, P.MED_ST:P.MED_ST + 3], tab[med, P.MED_SS:P.MED_SS + 3]
    vac = tab[med, P.MED_VAC] > 0.5
    ch = np.floor(u_ch * 3.0)
    sig = np.where(ch == 0.0, st[:, 0], np.where(ch == 1.0, st[:, 1],
                                                 st[:, 2]))
    dist = -np.log(np.maximum(1.0 - u, 1e-10)) / np.maximum(sig, 1e-20)
    sampled = dist < t_max
    t = np.minimum(dist, t_max)
    tr = np.exp(-st * t[:, None])
    dens = np.where(sampled[:, None], st * tr, tr)
    pdf = dens.sum(1) / 3.0
    guard = pdf == 0.0
    pdf = np.where(guard, 1.0, pdf)
    w = np.where(sampled[:, None], tr * ss, tr) / pdf[:, None]
    return (sampled & ~vac, np.where(vac, 0.0, t),
            np.where(vac[:, None], 1.0, w), dist, guard & ~vac)


def test_med_sample_matches_float64_transcription(media):
    _, tab = media
    med, med_f, st = _lanes(6)
    r = np.random.default_rng(7)
    t_max = np.float32(np.exp(r.uniform(np.log(1e-3), np.log(50.0), N)))
    # misses: the medium without red extinction, an unbounded segment
    far = (med == 6) & (r.uniform(size=N) < 0.5)
    t_max[far] = 1e30
    u_ch, u = _draws(st, 2)
    sampled, t, w, st_out = MD.med_sample(tab, med_f,
                                          torch.from_numpy(t_max), st)
    assert torch.equal(st_out, rng.uniform(rng.uniform(st)[1])[1])
    s64, t64, w64, dist, guard = _med_sample64(
        tab.double().numpy(), med, t_max.astype(np.float64), u_ch, u)
    # the branch agrees wherever the distance is not at the segment's end
    clear = np.abs(dist - t_max) > 1e-5 * t_max
    assert clear.mean() > 0.99
    sampled = sampled.numpy()
    assert np.array_equal(sampled[clear], s64[clear])
    ok = clear & (sampled == s64)
    np.testing.assert_allclose(t.numpy()[ok], t64[ok], rtol=1e-5, atol=0)
    for c in range(3):
        np.testing.assert_allclose(w[c].numpy()[ok], w64[ok, c], rtol=2e-5,
                                   atol=1e-30)
    # every case ran: vacuum, scatter, clamp to t_max, the pdf guard
    assert (med == 0).any() and (t.numpy()[med == 0] == 0.0).all()
    assert (w[0].numpy()[med == 0] == 1.0).all()
    assert s64.mean() > 0.1 and (~s64 & (med != 0)).mean() > 0.1
    # the guard: a scatter in a channel without extinction, every density
    # 0, gives the weight 0 and not 0 / 0
    assert guard.sum() >= 10
    for c in range(3):
        assert (w[c].numpy()[guard] == 0.0).all() and (w64[guard] == 0).all()


def _onb64(w):
    """onb_from_w (pallas_path.py:3505) in float64."""
    x_major = np.abs(w[:, 0]) > np.abs(w[:, 1])
    inv = 1.0 / np.sqrt(np.maximum(np.where(
        x_major, w[:, 0] ** 2 + w[:, 2] ** 2, w[:, 1] ** 2 + w[:, 2] ** 2),
        1e-20))
    u = np.stack([np.where(x_major, -w[:, 2], 0.0),
                  np.where(x_major, 0.0, w[:, 2]),
                  np.where(x_major, w[:, 0], -w[:, 1])], 1) * inv[:, None]
    return u, np.cross(w, u)


def _med_sample_p64(g, wo, u0, u1):
    """pallas_path.py:3343-3361 in float64."""
    iso = 1.0 - 2.0 * u0
    sqr = (1.0 - g * g) / np.maximum(1.0 + g - 2.0 * g * u0, 1e-9)
    aniso = -(1.0 + g * g - sqr * sqr) / np.where(np.abs(g) < 1e-9, 1e-9,
                                                  2.0 * g)
    cos_t = np.where(np.abs(g) < 1e-3, iso, aniso)
    sin_t = np.sqrt(np.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u1
    u, v = _onb64(wo)
    d = (u * (np.cos(phi) * sin_t)[:, None] + v * (np.sin(phi) * sin_t)[:, None]
         + wo * cos_t[:, None])
    return d, sin_t


def _unit(seed, n):
    w = np.random.default_rng(seed).normal(size=(n, 3))
    return np.float32(w / np.linalg.norm(w, axis=1, keepdims=True))


def test_med_sample_p_matches_float64_transcription(media):
    """Every g (vacuum lanes sample isotropically, g 5e-4 too); the
    direction agrees within 1e-5 plus the float32 error of cos theta
    carried into sin theta."""
    _, tab = media
    med, med_f, st = _lanes(8)
    wo = _unit(9, N)
    u0, u1 = _draws(st, 2)
    out = MD.med_sample_p(tab, med_f, *(torch.from_numpy(wo[:, a])
                                        for a in range(3)), st)
    d = np.stack([o.numpy() for o in out[:3]], 1)
    d64, sin64 = _med_sample_p64(np.float64(np.float32(G))[med],
                                 wo.astype(np.float64), u0, u1)
    err = np.abs(d - d64).max(1)
    assert (err <= 1e-5 + 4e-6 / np.maximum(sin64, 1e-6)).all(), err.max()
    assert np.abs(np.linalg.norm(d, axis=1) - 1.0).max() < 1e-5
    assert set(np.unique(med)) == set(range(len(G)))


@pytest.mark.parametrize("g", [0.0, 5e-4, 0.3, 0.9, -0.9])
def test_hg_mean_cosine_is_g(g):
    """Henyey-Greenstein sampling about the ray's direction -wo: the mean
    cosine of the scattered direction with it is g."""
    n = 1 << 16
    bn = _media_buffers()
    bn["med_g"][1] = g
    tab = torch.from_numpy(np.float32(P.media_table(bn)))
    wo = torch.from_numpy(_unit(10, n))
    st = torch.from_numpy(np.random.default_rng(11).integers(
        1, 2 ** 32, n, dtype=np.uint64).astype(np.int64))
    dx, dy, dz, _ = MD.med_sample_p(tab, torch.ones(n), wo[:, 0], wo[:, 1],
                                    wo[:, 2], st)
    cos = -(dx * wo[:, 0] + dy * wo[:, 1] + dz * wo[:, 2]).double()
    assert abs(float(cos.mean()) - g) <= 0.01


SCENES = {
    "fog": lambda d: scenes.fog_scene(16, 8),
    "fog_env": lambda d: scenes.fog_env_scene(d, 16, 8),
    "fog_mesh": lambda d: scenes.fog_mesh_scene(16, 8, small=True),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_media_and_slots_match_pack_scene(name, tmp_path, monkeypatch):
    """The media table is `pack_scene`'s `media` (sigma_t the float64 sum
    of sigma_a and sigma_s, cast once); every immediate's slot holds its
    record's material type, `imed` and `emed`; and the (type, imed, emed)
    triples of all slots in use, mesh rows, instances and table spheres
    included, are the JAX packer's."""
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    from rene_tpu.integrators import pallas_path as pp
    monkeypatch.setattr(pp, "CLUSTER", 16)
    monkeypatch.setattr(pp, "SPH_BLOCK", 16)
    src = SCENES[name](tmp_path)
    bn, cfg = build_device_scene(create_scene(parse_pbrt(src), str(tmp_path)))
    assert cfg.integrator == "volpath" and cfg.has_media
    ps = pp.pack_scene(bn, cfg)
    tb = P.pack_tables(bn, cfg)
    assert tb.volpath and not tb.use_rr
    assert tb.media.shape == (len(ps.media), P.MED_W) and len(ps.media) >= 2
    for row, rec in zip(tb.media, ps.media):
        np.testing.assert_array_equal(
            row[P.MED_ST:P.MED_ST + 3],
            np.float32(np.add(rec["sigma_a"], rec["sigma_s"])))
        np.testing.assert_array_equal(row[P.MED_SS:P.MED_SS + 3],
                                      np.float32(rec["sigma_s"]))
        assert row[P.MED_G] == np.float32(rec["g"])
        assert row[P.MED_VAC] == float(rec["vacuum"])

    def triple(slot):
        m = tb.mats[int(slot)]
        return int(m[P.MAT_TYPE]), int(m[P.MAT_IMED]), int(m[P.MAT_EMED])

    def ref_triple(rec):
        return int(rec["mat_type"]), rec["imed"], rec["emed"]

    for rows, col, recs in ((tb.tris, P.TRI_MAT, ps.tris),
                            (tb.spheres, P.SPH_MAT, ps.spheres)):
        assert len(rows) == len(recs)
        for row, rec in zip(rows, recs):
            assert triple(row[col]) == ref_triple(rec)
    from rene_tpu_torch.scene import accel as A
    # the world mesh's rows come first; a BLAS row's slot is its
    # instance's
    world = tb.mesh[:P.split_triangles(bn, cfg)[1].size, A.MESH_MAT]
    slots = (list(tb.tris[:, P.TRI_MAT]) + list(tb.spheres[:, P.SPH_MAT])
             + list(world) + list(tb.insts[:, A.INST_MAT])
             + list(tb.sph_tab[tb.sph_tab[:, A.SPHT_R] >= 0.0, A.SPHT_MAT]))
    mine = {triple(s) for s in slots}
    ref = {ref_triple(r) for r in (ps.tris + ps.spheres + (ps.mesh_mats or [])
                                   + (ps.sph_mats or []))}
    assert mine == ref
    # vacuum on both sides, the fog boundary, and shapes inside the fog
    assert {i for _, i, _ in mine} == {0, 1}
    assert (T.MAT_NONE, 1, 0) in mine
    assert any(t != T.MAT_NONE and i == e == 1 for t, i, e in mine)
    if name == "fog_mesh":
        # the vase (fog|fog), the box (fog|vacuum), the floor (vacuum)
        assert len({triple(s) for s in world}) == 3
        assert tb.insts.shape[0] == 8
