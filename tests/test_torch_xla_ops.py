"""The XLA engine's operations in the port against rene_tpu's, on the CPU.

Every input comes from a numpy seed and goes through the JAX function
and its port:

* PCG32si (ops/rng.py): bit for bit over 10^5 states, among them the
  seeds 0, 2^31 and 2^32 - 1 and pixel ids xor'd with uint32 seeds.
* `V3`, `Onb`, `coordinate_system`, the microfacet `tr_*` forms under
  GGX and Beckmann (RENE_MF_DIST) and `fresnel.evaluate`: atol 1e-6,
  rtol 1e-5.
* The lobe slots (`compute_bsdf`, `bsdf_f`, `bsdf_pdf`, `bsdf_sample_f`)
  on every material of `scenes.materials_scene` and of the checker-metal
  scene: the PCG states out bit for bit, f, pdf and wi within atol 1e-5,
  rtol 1e-4; `tex_color` on the checker of image maps.
* `trace`, `occluded` and `trace_emissive_pdf` through each accelerator
  (brute force, the matrix products, the BVH walk forced on a small
  mesh): the hit flags equal, t and the shading attributes within 1e-5 on
  at least 99.9% of the rays, the ids equal but at exact ties; a
  sphere's attributes on a cast with the reference's sphere t (see
  `test_casts`).
* ops/medium_xla.py.
* The gathers of ops/gather.py against what JAX does with an index out
  of range (`x[i]` clamps, `jnp.take` fills), and a scene whose texture
  dispatch reaches such an index.

XLA on the CPU contracts multiply-adds into FMAs and flushes subnormals;
torch does neither. The tolerances above cover the first; the inputs
here hold no subnormals.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rene_tpu.ops import bsdf as RB
from rene_tpu.ops import fresnel as RF
from rene_tpu.ops import intersect as RI
from rene_tpu.ops import medium as RM
from rene_tpu.ops import microfacet as RMF
from rene_tpu.ops import rng as RR
from rene_tpu.ops import texture as RT
from rene_tpu.ops import vec3 as RV
from rene_tpu.ops.accel import make_accel as r_make_accel
from rene_tpu.scene.device import to_jax
from rene_tpu_torch import scenes
from rene_tpu_torch.ops import bsdf as PB
from rene_tpu_torch.ops import fresnel as PF
from rene_tpu_torch.ops import gather as G
from rene_tpu_torch.ops import intersect as PI
from rene_tpu_torch.ops import medium_xla as PM
from rene_tpu_torch.ops import microfacet as PMF
from rene_tpu_torch.ops import rng as PR
from rene_tpu_torch.ops import texture as PT
from rene_tpu_torch.ops import vec3 as PV
from rene_tpu_torch.ops.accel import make_accel as p_make_accel
from rene_tpu_torch.scene import load_scene
from rene_tpu_torch.scene.device import build_device_scene, to_torch

torch.set_num_threads(2)

ATOL, RTOL = 1e-6, 1e-5           # vector math, microfacet, Fresnel
B_ATOL, B_RTOL = 1e-5, 1e-4       # the lobe slots
N = 4096


def tt(a):
    return torch.from_numpy(np.array(np.asarray(a)))


def jj(a):
    return jnp.asarray(np.asarray(a))


def rv3(a):
    return RV.V3(*(jj(a[i]) for i in range(3)))


def pv3(a):
    return PV.V3(*(tt(a[i]) for i in range(3)))


def close(got, want, atol=ATOL, rtol=RTOL, what=""):
    if isinstance(got, PV.V3):
        got = torch.stack(list(got))
        want = np.stack([np.asarray(c) for c in want])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol, err_msg=what)


def close_share(got, want, atol=ATOL, rtol=RTOL, frac=0.999):
    """At least `frac` of the lanes within the tolerance in every
    component."""
    got = torch.stack(list(got)).numpy()
    want = np.stack([np.asarray(c) for c in want])
    ok = (np.abs(got - want) <= atol + rtol * np.abs(want)).all(0)
    assert ok.mean() >= frac, ok.mean()


def unit(rng, n=N):
    v = rng.normal(size=(3, n)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def scene(src, tmp_path, name="s"):
    p = tmp_path / f"{name}.pbrt"
    p.write_text(src)
    return build_device_scene(load_scene(str(p)))


def test_pcg_bit_for_bit():
    g = np.random.default_rng(1)
    seeds = g.integers(0, 2 ** 32, 10 ** 5, dtype=np.uint64).astype(
        np.uint32)
    seeds[:3] = [0, 2 ** 31, 2 ** 32 - 1]
    pix = np.arange(10 ** 5, dtype=np.uint32)
    for s in (seeds, pix ^ np.uint32(2 ** 32 - 1), pix ^ np.uint32(2 ** 31),
              pix ^ np.uint32(123456789)):
        a = RR.pcg_init(jnp.asarray(s))
        b = PR.pcg_init(torch.from_numpy(s.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b)
        for _ in range(3):
            ua, a = RR.next_u32(a)
            ub, b = PR.next_u32(b)
            np.testing.assert_array_equal(np.asarray(ua).astype(np.int64),
                                          ub)
            fa, a = RR.next_f32(a)
            fb, b = PR.next_f32(b)
            np.testing.assert_array_equal(np.asarray(fa), fb.numpy())
            ra, a = RR.next_f32_range(a, -2.0, 3.0)
            rb, b = PR.next_f32_range(b, -2.0, 3.0)
            np.testing.assert_array_equal(np.asarray(ra), rb.numpy())
    # a python int seed and a state past 2^31
    a = RR.pcg_init(jnp.uint32(4000000000))
    b = PR.pcg_init(4000000000)
    assert int(np.asarray(a)) == int(b)


def test_vec3_onb_and_frames():
    g = np.random.default_rng(2)
    a = g.normal(size=(3, N)).astype(np.float32)
    b = g.normal(size=(3, N)).astype(np.float32)
    n = unit(g)
    m = g.normal(size=(3, 4)).astype(np.float32)
    ra, rb, pa, pb = rv3(a), rv3(b), pv3(a), pv3(b)
    close(pa.cross(pb), ra.cross(rb))
    close(pa.normalized(), ra.normalized())
    close(pa.dot(pb), ra.dot(rb))
    close(PV.reflect(pa, pv3(n)), RV.reflect(ra, rv3(n)))
    close(PV.face_forward(pa, pb), RV.face_forward(ra, rb))
    for x, y in zip(PV.coordinate_system(pv3(n)),
                    RV.coordinate_system(rv3(n))):
        close(x, y)
    po, ro = PV.Onb.from_w(pv3(n)), RV.Onb.from_w(rv3(n))
    close(po.to_local(pa), ro.to_local(ra))
    close(po.to_world(pa), ro.to_world(ra))
    for f in ("cos_phi", "sin_phi", "tan2_theta", "sin2_theta"):
        close(getattr(PV, f)(pv3(n)), getattr(RV, f)(rv3(n)), what=f)
    for x, y in zip(PV.sphere_uv(pv3(n)), RV.sphere_uv(rv3(n))):
        close(x, y)
    close(PV.affine_point(m.tolist(), pa), RV.affine_point(jj(m), ra))
    close(PV.affine_vector(tt(m), pa), RV.affine_vector(jj(m), ra))
    mask = g.random(N) < 0.5
    close(PV.where(tt(mask), pa, 2.0), RV.where(jj(mask), ra, 2.0))


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_microfacet(dist, monkeypatch):
    monkeypatch.setenv("RENE_MF_DIST", dist)
    g = np.random.default_rng(3)
    wo, wi = unit(g), unit(g)
    wh = unit(g)
    ax = g.uniform(0.02, 0.8, N).astype(np.float32)
    ay = g.uniform(0.02, 0.8, N).astype(np.float32)
    u1, u2 = (g.random(N).astype(np.float32) for _ in range(2))
    r = g.uniform(0.0, 1.0, N).astype(np.float32)
    close(PMF.roughness_to_alpha(tt(r)), RMF.roughness_to_alpha(jj(r)))
    pa, pay, ra, ray = tt(ax), tt(ay), jj(ax), jj(ay)
    close(PMF.tr_d(pa, pay, pv3(wh)), RMF.tr_d(ra, ray, rv3(wh)))
    close(PMF.tr_lambda(pa, pay, pv3(wo)), RMF.tr_lambda(ra, ray, rv3(wo)))
    close(PMF.tr_g(pa, pay, pv3(wo), pv3(wi)),
          RMF.tr_g(ra, ray, rv3(wo), rv3(wi)))
    close(PMF.tr_g1(pa, pay, pv3(wo)), RMF.tr_g1(ra, ray, rv3(wo)))
    close(PMF.tr_pdf(pa, pay, pv3(wo), pv3(wh)),
          RMF.tr_pdf(ra, ray, rv3(wo), rv3(wh)))
    # the sampled normal on 99.9% of the lanes: Beckmann's sin(theta) =
    # sqrt(1 - cos^2) cancels near the pole, where XLA's fused
    # multiply-add and torch's two roundings part by up to 3e-6
    close_share(PMF.tr_sample_wh(pa, pay, pv3(wo), tt(u1), tt(u2)),
                RMF.tr_sample_wh(ra, ray, rv3(wo), jj(u1), jj(u2)))


def test_fresnel_evaluate():
    from rene_tpu_torch.scene import types as T
    g = np.random.default_rng(4)
    cos_i = g.uniform(-1, 1, N).astype(np.float32)
    kind = g.choice([T.FRESNEL_CONDUCTOR, T.FRESNEL_NOOP,
                     T.FRESNEL_DIELECTRIC], N).astype(np.int32)
    eta_i = g.uniform(1.0, 1.6, (3, N)).astype(np.float32)
    eta_t = g.uniform(0.2, 2.5, (3, N)).astype(np.float32)
    k = g.uniform(0.0, 4.0, (3, N)).astype(np.float32)
    close(PF.evaluate(tt(kind), pv3(eta_i), pv3(eta_t), pv3(k), tt(cos_i)),
          RF.evaluate(jj(kind), rv3(eta_i), rv3(eta_t), rv3(k), jj(cos_i)))
    close(PF.fr_dielectric(tt(cos_i), tt(eta_i[0]), tt(eta_t[0])),
          RF.fr_dielectric(jj(cos_i), jj(eta_i[0]), jj(eta_t[0])))


def _bsdf_case(bn, cfg, seed, n=N):
    """Random lanes over every material of the scene: material ids, uv,
    shading normals, wo and wi, and PCG states."""
    g = np.random.default_rng(seed)
    mats = g.integers(0, bn["mat_type"].shape[0], n).astype(np.int32)
    uv = g.uniform(-0.5, 1.5, (2, n)).astype(np.float32)
    nrm, wo, wi = unit(g, n), unit(g, n), unit(g, n)
    st = g.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return mats, uv, nrm, wo, wi, st


@pytest.mark.parametrize("which", ["materials", "checker_metal"])
def test_lobe_slots(which, tmp_path):
    src = (scenes.materials_scene(8, 4) if which == "materials"
           else scenes.checker_metal_scene(tmp_path, 8, 4))
    bn, cfg = scene(src, tmp_path)
    jb, tb = to_jax(bn), to_torch(bn, "cpu")
    mats, uv, nrm, wo, wi, st = _bsdf_case(bn, cfg, 5)
    r_slots = RB.compute_bsdf(jb, jj(mats), (jj(uv[0]), jj(uv[1])), cfg)
    p_slots = PB.compute_bsdf(tb, tt(mats).long(), (tt(uv[0]), tt(uv[1])),
                              cfg)
    assert len(r_slots) == len(p_slots) == cfg.max_lobes
    for rs, ps in zip(r_slots, p_slots):
        np.testing.assert_array_equal(np.asarray(rs["active"]), ps["active"])
        np.testing.assert_array_equal(np.asarray(rs["type"]), ps["type"])
        for k in ("v0", "v1", "fr_eta_t", "fr_k"):
            close(ps[k], rs[k], B_ATOL, B_RTOL, k)
        close(ps["ax"], rs["ax"], B_ATOL, B_RTOL)
    ro, po = RV.Onb.from_w(rv3(nrm)), PV.Onb.from_w(pv3(nrm))
    close(PB.bsdf_f(p_slots, po, pv3(nrm), pv3(wo), pv3(wi), cfg),
          RB.bsdf_f(r_slots, ro, rv3(nrm), rv3(wo), rv3(wi), cfg),
          B_ATOL, B_RTOL, "f")
    close(PB.bsdf_pdf(p_slots, po, pv3(wo), pv3(wi), cfg),
          RB.bsdf_pdf(r_slots, ro, rv3(wo), rv3(wi), cfg), B_ATOL, B_RTOL,
          "pdf")
    rw, rf, rp, rst = RB.bsdf_sample_f(r_slots, ro, rv3(wo), jj(st), cfg)
    pw, pf, pp, pst = PB.bsdf_sample_f(p_slots, po, pv3(wo),
                                       tt(st.astype(np.int64)), cfg)
    np.testing.assert_array_equal(np.asarray(rst).astype(np.int64), pst)
    close(pw, rw, B_ATOL, B_RTOL, "wi")
    close(pf, rf, B_ATOL, B_RTOL, "f")
    close(pp, rp, B_ATOL, B_RTOL, "pdf")
    close(PB.material_albedo(tb, tt(mats).long(), (tt(uv[0]), tt(uv[1])),
                             cfg),
          RB.material_albedo(jb, jj(mats), (jj(uv[0]), jj(uv[1])), cfg),
          B_ATOL, B_RTOL)
    from rene_tpu_torch.scene import types as T
    for kind in (T.KIND_DIFFUSE, T.KIND_REFLECTION, T.KIND_TRANSMISSION):
        np.testing.assert_array_equal(
            np.asarray(RB.bsdf_contains(r_slots, kind)),
            PB.bsdf_contains(p_slots, kind))
    np.testing.assert_array_equal(
        np.asarray(RB.bsdf_num_lobes(r_slots)), PB.bsdf_num_lobes(p_slots))


def test_tex_color_checker_of_images(tmp_path):
    """Every texture of the checker-metal scene at random uv, the
    checkers of image maps among them, and the reads past the image table
    that their payloads make (a sub-texture id taken as an image id)."""
    bn, cfg = scene(scenes.checker_metal_scene(tmp_path, 8, 4), tmp_path)
    ntex = bn["tex_type"].shape[0]
    n_img = bn["img_width"].shape[0]
    from rene_tpu_torch.scene import types as T
    checkers = np.nonzero(bn["tex_type"] == T.TEX_CHECKER)[0]
    assert checkers.size == 2
    # a checker's sub-texture ids, read by the image fetch as image ids,
    # run past the image table: JAX clamps them, the port must too
    assert (bn["tex_u0"][checkers, :2] >= n_img).any()
    g = np.random.default_rng(6)
    idx = g.integers(0, ntex, N).astype(np.int32)
    u, v = (g.uniform(-2, 3, N).astype(np.float32) for _ in range(2))
    close(PT.tex_color(to_torch(bn, "cpu"), tt(idx).long(), (tt(u), tt(v)),
                       cfg),
          RT.tex_color(to_jax(bn), jj(idx), (jj(u), jj(v)), cfg),
          atol=2e-6, rtol=1e-5)


def test_gathers_follow_jax():
    x = np.arange(5, dtype=np.float32)
    xi = np.arange(5, dtype=np.int32)
    idx = np.array([-1, 7, 2, -7, -5, 5, 0, 4])
    np.testing.assert_array_equal(G.at(tt(x), tt(idx)), np.asarray(
        jj(x)[jj(idx)]))
    np.testing.assert_array_equal(G.at(tt(xi), tt(idx)), np.asarray(
        jj(xi)[jj(idx)]))
    np.testing.assert_array_equal(G.take(tt(x), tt(idx)), np.asarray(
        jnp.take(jj(x), jj(idx))))
    np.testing.assert_array_equal(G.take(tt(xi), tt(idx)), np.asarray(
        jnp.take(jj(xi), jj(idx))))
    t2 = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(G.take(tt(t2), tt(idx), dim=1),
                                  np.asarray(jnp.take(jj(t2), jj(idx),
                                                      axis=1)))
    np.testing.assert_array_equal(G.at(tt(t2.T), tt(idx)),
                                  np.asarray(jj(t2.T)[jj(idx)]))
    f = np.array([np.nan, 3e9, -3e9, 2.7, -2.7, 0.5], np.float32)
    np.testing.assert_array_equal(PT.to_i32(tt(f)),
                                  np.asarray(jj(f).astype(jnp.int32)))


def _rays(rng, n, lo, hi, toward):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    t = toward + rng.normal(scale=0.6, size=(n, 3))
    d = (t - o) / np.linalg.norm(t - o, axis=1, keepdims=True)
    return o.T.astype(np.float32).copy(), d.T.astype(np.float32).copy()


CAST_SCENES = {
    "materials": (lambda d: scenes.materials_scene(8, 4), None, (0, 0, 0.6)),
    "cornell": (lambda d: scenes.cornell_box(8, 8), None, (0, 1, 0)),
    "mesh_bvh": (lambda d: scenes.mesh_materials_scene(8, 4), "bvh",
                 (0, 0, 0.6)),
    "emissive_grid": (lambda d: scenes.emissive_grid_scene(8, 4), None,
                      (0, 0, 1.5)),
}


def _attrs_ok(ph, rh):
    """Lanes whose t, position, normal and uv agree within 1e-5 (relative
    above 1)."""
    ok = np.ones(np.asarray(rh["t"]).shape, bool)
    for k in ("t", "position", "normal", "uv"):
        pairs = zip([ph[k]], [rh[k]]) if k == "t" else zip(ph[k], rh[k])
        for a, b in pairs:
            b = np.asarray(b, np.float64)
            ok &= np.abs(np.asarray(a, np.float64) - b) <= \
                1e-5 * np.maximum(1.0, np.abs(b))
    return ok


@pytest.mark.parametrize("accel", ["brute", "mxu_or_bvh"])
@pytest.mark.parametrize("name", sorted(CAST_SCENES))
def test_casts(name, accel, tmp_path, monkeypatch):
    """The hit flags equal; t within 1e-5 and the ids equal (but at
    ties) on 99.9% of the hits; the shading attributes within 1e-5 on
    99.9% of them. A sphere's hit point and normal follow its t, which
    the reference's quadratic (object space, an unnormalized direction)
    loses digits of to cancellation, lost differently by XLA's fused
    multiply-adds and torch's separate roundings; the hit point's error
    reaches the normal scaled by the sphere's inverse radius, past 1e-5 on
    some random rays. So the attributes are held on a second cast whose
    sphere t and id are the reference's, which tests the attribute code
    itself; t alone is held above."""
    src, force, toward = CAST_SCENES[name]
    bn, cfg = scene(src(tmp_path), tmp_path)
    jb, tb = to_jax(bn), to_torch(bn, "cpu")
    ra = pa = None
    if accel != "brute":
        ra = r_make_accel(bn, cfg, force=force)
        pa = p_make_accel(bn, cfg, "cpu", force=force)
    g = np.random.default_rng(7)
    o, d = _rays(g, 2048, -3.0, 3.0, np.asarray(toward))
    o[2] = np.abs(o[2]) + 0.05       # above the floor
    rh = RI.trace(jb, cfg, rv3(o), rv3(d), 1e-3, 1e5, accel=ra)
    ph = PI.trace(tb, cfg, pv3(o), pv3(d), 1e-3, 1e5, accel=pa)
    hit = np.asarray(rh["hit"])
    np.testing.assert_array_equal(hit, ph["hit"])
    assert hit.mean() > 0.2
    t_ok = (np.abs(ph["t"].numpy() - np.asarray(rh["t"]))
            <= 1e-5 * np.maximum(1.0, np.abs(np.asarray(rh["t"]))))
    assert t_ok[hit].mean() >= 0.999
    # where the ids differ, the hit is a tie in t (to float32 rounding)
    same = ((np.asarray(rh["inst"]) == ph["inst"].numpy())
            & (np.asarray(rh["kind"]) == ph["kind"].numpy()))
    assert same[hit].mean() >= 0.999
    assert np.allclose(ph["t"].numpy()[hit & ~same],
                       np.asarray(rh["t"])[hit & ~same], rtol=1e-5)
    if cfg.num_spheres:
        rs = RI.intersect_spheres_v3(jb, cfg, rv3(o), rv3(d),
                                     jj(np.full(o.shape[1], 1e-3)),
                                     jj(np.full(o.shape[1], 1e5)))
        ref_sph = (tt(rs[0]), tt(rs[1]).long())
        monkeypatch.setattr(PI, "intersect_spheres_v3",
                            lambda *a, **k: ref_sph)
        ph = PI.trace(tb, cfg, pv3(o), pv3(d), 1e-3, 1e5, accel=pa)
    assert _attrs_ok(ph, rh)[hit].mean() >= 0.999
    monkeypatch.undo()

    tmax = g.uniform(0.5, 8.0, o.shape[1]).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(RI.occluded(jb, cfg, rv3(o), rv3(d), 1e-3, jj(tmax),
                               accel=ra)),
        PI.occluded(tb, cfg, pv3(o), pv3(d), 1e-3, tt(tmax), accel=pa))
    if cfg.num_emit_objects:
        rp = np.asarray(RI.trace_emissive_pdf(jb, cfg, rv3(o), rv3(d), 1e-3,
                                              1e5, accel=ra))
        pp = PI.trace_emissive_pdf(tb, cfg, pv3(o), pv3(d), 1e-3, 1e5,
                                   accel=pa).numpy()
        assert (rp > 0).any()
        assert np.mean(np.abs(pp - rp) <= 1e-5 + 1e-4 * np.abs(rp)) >= 0.999


def test_stretched_sphere_casts(tmp_path):
    """many_spheres_scene's 65 spheres scaled 1 x 2 x 1: the hit flags
    equal, t within 1e-5 on 99.9% of the hits, the closest sphere the
    same but at ties."""
    bn, cfg = scene(scenes.many_spheres_scene(8, 4), tmp_path)
    jb, tb = to_jax(bn), to_torch(bn, "cpu")
    g = np.random.default_rng(11)
    o, d = _rays(g, 2048, -3.0, 3.0, np.array([0, 0, 0.5]))
    o[2] = np.abs(o[2]) + 0.05
    lo = np.full(o.shape[1], 1e-3, np.float32)
    hi = np.full(o.shape[1], 1e5, np.float32)
    rt, rid = RI.intersect_spheres_v3(jb, cfg, rv3(o), rv3(d), jj(lo),
                                      jj(hi))
    pt, pid = PI.intersect_spheres_v3(tb, cfg, pv3(o), pv3(d), tt(lo),
                                      tt(hi))
    rt, rid = np.asarray(rt), np.asarray(rid)
    hit = rt < 1e29
    np.testing.assert_array_equal(hit, pt.numpy() < 1e29)
    assert hit.mean() > 0.2
    assert np.mean(np.abs(pt.numpy() - rt)[hit]
                   <= 1e-5 * np.maximum(1.0, rt[hit])) >= 0.999
    assert np.mean(pid.numpy()[hit] == rid[hit]) >= 0.999


def test_bvh_walk_against_brute_force(tmp_path):
    """The BVH walk of the port against the reference's on a mesh: the
    same t and triangle on every ray, and a miss reads (1e30, 0)."""
    bn, cfg = scene(scenes.mesh_materials_scene(8, 4), tmp_path)
    ra = r_make_accel(bn, cfg, force="bvh")
    pa = p_make_accel(bn, cfg, "cpu", force="bvh")
    g = np.random.default_rng(8)
    o, d = _rays(g, 4096, -3.0, 3.0, np.array([0, 0, 0.6]))
    tmin = np.full(o.shape[1], 1e-3, np.float32)
    tmax = g.uniform(1.0, 1e5, o.shape[1]).astype(np.float32)
    rt, rid = ra.main.intersect(jj(o.T), jj(d.T), jj(tmin), jj(tmax))
    pt, pid = pa.main.intersect(tt(o.T), tt(d.T), tt(tmin), tt(tmax))
    rt, rid = np.asarray(rt), np.asarray(rid)
    assert (rt < 1e29).mean() > 0.1 and (rt >= 1e29).any()
    np.testing.assert_allclose(pt.numpy(), rt, rtol=1e-5)
    assert np.mean(pid.numpy() == rid) >= 0.999
    assert (pid.numpy()[rt >= 1e29] == 0).all()


def test_medium_forms(tmp_path):
    bn, cfg = scene(scenes.fog_scene(8, 4), tmp_path)
    jb, tb = to_jax(bn), to_torch(bn, "cpu")
    g = np.random.default_rng(9)
    n_med = bn["med_type"].shape[0]
    assert n_med >= 2
    med = g.integers(0, n_med, N).astype(np.int32)
    o = g.normal(size=(3, N)).astype(np.float32)
    d = unit(g) * g.uniform(0.5, 2.0, N).astype(np.float32)
    wo, wi = unit(g), unit(g)
    t = g.uniform(0.0, 30.0, N).astype(np.float32)
    st = g.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    pm = tt(med).long()
    close(PM.med_tr(tb, pm, pv3(d), tt(t)), RM.med_tr(jb, jj(med), rv3(d),
                                                      jj(t)))
    np.testing.assert_array_equal(np.asarray(RM.med_is_vacuum(jb,
                                                              jj(med))),
                                  PM.med_is_vacuum(tb, pm))
    rs = RM.med_sample(jb, jj(med), rv3(o), rv3(d), jj(t), jj(st))
    ps = PM.med_sample(tb, pm, pv3(o), pv3(d), tt(t),
                       tt(st.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(rs[0]), ps[0])
    assert np.asarray(rs[0]).any() and not np.asarray(rs[0]).all()
    close(ps[1], rs[1], atol=1e-5)
    close(ps[2], rs[2], atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(rs[3]).astype(np.int64), ps[3])
    close(PM.med_phase(tb, pm, pv3(wo), pv3(wi)),
          RM.med_phase(jb, jj(med), rv3(wo), rv3(wi)))
    rd, rst = RM.med_sample_p(jb, jj(med), rv3(wo), jj(st))
    pd, pst = PM.med_sample_p(tb, pm, pv3(wo), tt(st.astype(np.int64)))
    close(pd, rd, atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(rst).astype(np.int64), pst)
