"""The XLA engine of the port against rene_tpu's, on the CPU.

* Per pixel: `path.render_batch` and `volpath.render_batch` against
  rene_tpu's on the same pixels, seed and sample count, each pixel's
  PCG32si stream drawn alike, held by `checks.agreement`: radiance on at
  least 99.5% of the pixels, normal and albedo on at least 99%, image
  means within 1e-3 relative, ray totals within 0.1%. The scenes: the
  Cornell box (the matrix-product intersector), `materials_scene`, a mesh
  with the BVH walk forced, the checker-metal, emissive-grid and
  65-sphere scenes the kernels refuse, `fog_scene` and the refused fog
  scene with the 65 spheres.
* `render(engine="xla")` against `rene_tpu.render.render(engine="xla")`:
  the same chunk seeds (uint32), the film by the same rule.
* `auto` sends each refused scene to the XLA engine, saying why, and
  "pallas" and "wave" still raise on it; the 1025-light scene renders
  through `auto` (no JAX render of it: the reference unrolls its light
  loop, 1025 traced shadow casts, and compiling them takes minutes).
* A checkpointed XLA render stopped after its first chunk and resumed
  equals an unbroken one bit for bit, `varmean` included; a megakernel
  checkpoint offered to it is ignored with a warning. The tile size does
  not change the image. `warm_cache(engine="xla")` builds nothing. The CLI
  with `--engine xla --bvh on --tile-rays 256 --device cpu` writes its
  PNGs.

XLA flushes subnormals to zero and torch does not: the port ends a path
whose throughput is all subnormal (integrators/path.py `any_normal`), as
the flush would, and the ray totals count alike. XLA on the CPU also
contracts multiply-adds into FMAs, which moves a rare lane to the other
side of a branch; hence the shares above. Each comparison prints its
agreement (`pytest -s`); PERF.md quotes them. The reference's sphere
quadratic (object space, an unnormalized direction) loses digits of t to
cancellation on small, far spheres, lost differently under XLA's FMAs, and
the AOV normal sums then part by more than 1e-4: the 65-sphere scene's
spheres have radius 0.5.
"""
import logging

import numpy as np
import pytest
import torch

from rene_tpu_torch import checks, scenes
from rene_tpu_torch import render as PR
from rene_tpu_torch.scene import load_scene

torch.set_num_threads(2)

RAD_FRAC, AOV_FRAC, MEAN_REL, RAYS_REL = 0.995, 0.99, 1e-3, 1e-3


def write(tmp_path, name, src):
    p = tmp_path / f"{name}.pbrt"
    p.write_text(src)
    return str(p)


def _rows(out):
    """(9, N) rows of a render_batch's radiance, normal and albedo sums."""
    return np.concatenate([np.asarray(out[k]).T
                           for k in ("radiance", "normal", "albedo")])


def assert_agree(got, want, rays_got, rays_want, what):
    a = checks.agreement(got, want)
    print(f"{what}: radiance {a['rad_frac']:.5f}, AOV {a['aov_frac']:.5f}"
          f", mean_rel {a['mean_rel']:.3g}, rays {rays_got:.0f} / "
          f"{rays_want:.0f}")
    assert a["rad_frac"] >= RAD_FRAC, (what, a)
    assert a["aov_frac"] >= AOV_FRAC, (what, a)
    assert a["mean_rel"] <= MEAN_REL, (what, a)
    assert abs(rays_got - rays_want) <= RAYS_REL * rays_want, (
        what, rays_got, rays_want)


PIXEL_SCENES = {
    "cornell": (lambda d: scenes.cornell_box(32, 32), None),
    "materials": (lambda d: scenes.materials_scene(32, 16), None),
    "mesh_bvh": (lambda d: scenes.mesh_materials_scene(32, 16), "bvh"),
    "checker_metal": (lambda d: scenes.checker_metal_scene(d, 32, 16),
                      None),
    "emissive_grid": (lambda d: scenes.emissive_grid_scene(32, 16), None),
    "many_spheres": (lambda d: scenes.many_spheres_scene(32, 32), None),
    "fog": (lambda d: scenes.fog_scene(32, 16), None),
    "fog_spheres": (lambda d: scenes.fog_spheres_scene(32, 16), None),
}


@pytest.mark.parametrize("name", sorted(PIXEL_SCENES))
def test_render_batch_per_pixel(name, tmp_path):
    import jax.numpy as jnp

    from rene_tpu import render as RR
    from rene_tpu.ops.accel import make_accel as r_make_accel
    from rene_tpu.scene import load_scene as r_load_scene
    from rene_tpu.scene.device import build_device_scene as r_build
    from rene_tpu.scene.device import to_jax
    from rene_tpu_torch.integrators import path, volpath
    from rene_tpu_torch.ops.accel import make_accel
    from rene_tpu_torch.scene.device import build_device_scene, to_torch

    src, force = PIXEL_SCENES[name]
    p = write(tmp_path, name, src(tmp_path))
    rb, rc = r_build(r_load_scene(p))
    pb, pc = build_device_scene(load_scene(p))
    assert pc.integrator == ("volpath" if name.startswith("fog")
                             else "path")
    w, h = pc.film.xresolution, pc.film.yresolution
    ys, xs = np.mgrid[0:h, 0:w]
    px = xs.reshape(-1).astype(np.int32)
    py = ys.reshape(-1).astype(np.int32)
    spp, seed = 4, 3000000000       # a uint32 seed past 2^31
    run, _ = RR._batch_fn(rc, accel=r_make_accel(rb, rc, force=force))
    ref = run(to_jax(rb), jnp.asarray(px), jnp.asarray(py),
              jnp.uint32(seed), spp)
    batch = (volpath.render_batch if pc.integrator == "volpath"
             else path.render_batch)
    out = batch(to_torch(pb, "cpu"), pc, torch.from_numpy(px),
                torch.from_numpy(py), seed, spp,
                accel=make_accel(pb, pc, "cpu", force=force))
    if force == "bvh":
        from rene_tpu_torch.ops.bvh import BVH
        assert isinstance(make_accel(pb, pc, "cpu", force=force).main, BVH)
    assert_agree(_rows(out), _rows(ref), float(out["rays"]),
                 float(ref["rays"]), name)


def _image_rows(out, spp):
    """(9, N) per-pixel sums from a render's averaged images."""
    return np.concatenate([(out[k].reshape(-1, 3) * spp).T
                           for k in ("color", "normal", "albedo")])


def test_render_matches_reference_render(tmp_path, monkeypatch):
    """render(engine="xla") and rene_tpu's: the same uint32 chunk seeds
    and chunk sizes (want_var: chunks of spp // 2), the film by the
    per-pixel rule."""
    from rene_tpu import render as RR
    from rene_tpu.scene import load_scene as r_load_scene

    p = write(tmp_path, "box", scenes.cornell_box(16, 12))
    r_calls, p_calls = [], []
    r_batch_fn, p_make = RR._batch_fn, PR.make_xla_fn

    def r_spy(config, accel=None):
        run, chunk = r_batch_fn(config, accel=accel)

        def spied(buffers, px, py, seed, num_samples):
            r_calls.append((int(seed), num_samples))
            return run(buffers, px, py, seed, num_samples)
        return spied, chunk

    def p_spy(*a, **k):
        run = p_make(*a, **k)

        def spied(seed, chunk):
            p_calls.append((seed, chunk))
            return run(seed, chunk)
        spied.__dict__.update(run.__dict__)
        return spied

    monkeypatch.setattr(RR, "_batch_fn", r_spy)
    monkeypatch.setattr(PR, "make_xla_fn", p_spy)
    spp = 5
    ref = RR.render(r_load_scene(p), spp=spp, seed=11, engine="xla",
                    want_var=True)
    out = PR.render(load_scene(p), spp=spp, seed=11, device="cpu",
                    engine="xla", want_var=True)
    assert out["engine"] == "xla" and out["launches"] == 0
    assert p_calls == r_calls and len(r_calls) == 3
    assert all(0 <= s < 2 ** 32 for s, _ in p_calls)
    assert_agree(_image_rows(out, spp), _image_rows(ref, spp),
                 out["total_rays"], ref["total_rays"], "render")
    assert np.isfinite(out["varmean"]).all()


@pytest.mark.parametrize("name", ["checker_metal", "emissive_grid",
                                  "many_spheres", "fog_spheres"])
def test_auto_renders_refused_scenes(name, tmp_path, caplog):
    p = write(tmp_path, name, scenes.REFUSED[name](tmp_path, 8, 4))
    with caplog.at_level(logging.INFO, "rene_tpu_torch"):
        out = PR.render(load_scene(p), spp=1, seed=2, device="cpu")
    assert out["engine"] == "xla" and out["color"].shape == (4, 8, 3)
    assert np.isfinite(out["color"]).all() and out["total_rays"] > 0
    assert out["color"].mean() > 0
    assert any("the kernels refuse the scene" in r.getMessage()
               for r in caplog.records)
    for engine in ("pallas", "wave"):
        with pytest.raises(NotImplementedError, match="--engine xla"):
            PR.render(load_scene(p), spp=1, device="cpu", engine=engine)
    assert PR.warm_cache(load_scene(p), device="cuda") == 0


def test_auto_renders_1025_lights(tmp_path, caplog):
    p = write(tmp_path, "lights", scenes.many_lights_scene(4, 4,
                                                           maxdepth=2))
    with caplog.at_level(logging.INFO, "rene_tpu_torch"):
        out = PR.render(load_scene(p), spp=1, seed=1, device="cpu")
    assert out["engine"] == "xla"
    assert any("1025 distant lights" in r.getMessage()
               for r in caplog.records)
    assert np.isfinite(out["color"]).all() and out["color"].mean() > 0
    # every active lane counts 1 + 1025 rays per bounce, no emitter
    assert out["total_rays"] % 1026 == 0 and out["total_rays"] >= 16 * 1026


@pytest.fixture
def box(tmp_path):
    return write(tmp_path, "box", scenes.cornell_box(12, 8))


class Stop(Exception):
    pass


def test_xla_checkpoint_resumes_bit_for_bit(box, tmp_path, caplog):
    """Stopped after its first chunk and resumed, an XLA render equals an
    unbroken one bit for bit, varmean included; a megakernel checkpoint
    offered to an XLA render is ignored with a warning."""
    kw = dict(spp=7, seed=5, device="cpu", engine="xla", want_var=True)
    full = PR.render(load_scene(box), **kw)
    ck = str(tmp_path / "ck.npz")
    seen = []

    def stop(done, spp, ms):
        seen.append(done)
        if len(seen) == 2:
            raise Stop
    with pytest.raises(Stop):
        PR.render(load_scene(box), checkpoint=ck, progress=stop, **kw)
    with np.load(ck) as z:
        assert int(z["samples_done"]) == 3 and int(z["seeds"]) == 1
    res = PR.render(load_scene(box), checkpoint=ck, resume=True, **kw)
    for k in ("color", "normal", "albedo", "varmean"):
        np.testing.assert_array_equal(res[k], full[k], err_msg=k)
    assert np.isfinite(full["varmean"]).all()

    mega = str(tmp_path / "mega.npz")
    PR.render(load_scene(box), spp=2, seed=5, device="cpu",
              engine="pallas", checkpoint=mega)
    with caplog.at_level(logging.INFO, "rene_tpu_torch"):
        again = PR.render(load_scene(box), spp=2, seed=5, device="cpu",
                          engine="xla", checkpoint=mega, resume=True)
    msgs = [r.getMessage() for r in caplog.records]
    assert any("ignoring it" in m for m in msgs)
    assert not any(m.startswith("resumed from") for m in msgs)
    assert again["engine"] == "xla"


def test_tiles_and_bvh_chunks(box, monkeypatch):
    """The film's tiling does not change the image (each pixel's stream
    is its own), nor does the BVH's tile cap; with the BVH forced the
    runner takes chunks of 4."""
    a = PR.render(load_scene(box), spp=3, seed=9, device="cpu",
                  engine="xla")
    b = PR.render(load_scene(box), spp=3, seed=9, device="cpu",
                  engine="xla", tile_rays=40)
    for k in ("color", "normal", "albedo"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert a["total_rays"] == b["total_rays"]
    from rene_tpu_torch.scene.device import build_device_scene
    bn, cfg = build_device_scene(load_scene(box))
    run = PR.make_xla_fn(bn, cfg, "cpu", use_bvh=True, tile_rays=1 << 18)
    assert run.chunk_hint == 4 and run.spp_mult == 1
    assert run.tiles == 1 and run.seed_dtype == np.uint32
    big = PR.make_xla_fn(bn, cfg, "cpu", use_bvh=None, tile_rays=40)
    assert big.chunk_hint == PR.LOG_EVERY and big.tiles == 3
    c = PR.render(load_scene(box), spp=3, seed=9, device="cpu",
                  engine="xla", use_bvh=True)
    assert c["color"].shape == a["color"].shape
    assert abs(c["color"].mean() - a["color"].mean()) <= 1e-3 * a[
        "color"].mean()
    # the BVH's tile cap bounds the tiles and leaves the image as it is
    monkeypatch.setattr(PR, "XLA_BVH_TILE", 32)
    assert PR.make_xla_fn(bn, cfg, "cpu", use_bvh=True).tiles == 3
    d = PR.render(load_scene(box), spp=3, seed=9, device="cpu",
                  engine="xla", use_bvh=True)
    for k in ("color", "normal", "albedo"):
        np.testing.assert_array_equal(c[k], d[k], err_msg=k)


def test_warm_cache_and_runner_for_xla(box):
    from rene_tpu_torch.scene.device import build_device_scene
    assert PR.warm_cache(load_scene(box), engine="xla", device="cuda") == 0
    bn, cfg = build_device_scene(load_scene(box))
    assert PR.runner_libraries(bn, cfg, "xla") == []
    assert PR._runner("xla", bn, cfg) == "xla"
    assert PR._runner("auto", bn, cfg) == "megakernel"


def test_cli_xla_writes_pngs(tmp_path):
    from rene_tpu_torch import cli
    p = write(tmp_path, "box", scenes.cornell_box(24, 16))
    out = tmp_path / "o.png"
    rc = cli.main([p, "--spp", "2", "--device", "cpu", "--engine", "xla",
                   "--bvh", "on", "--tile-rays", "256", "--output",
                   str(out), "--aov-normal", str(tmp_path / "n.png"),
                   "--aov-albedo", str(tmp_path / "a.png")])
    assert rc == 0
    for f in ("o.png", "n.png", "a.png"):
        assert (tmp_path / f).stat().st_size > 0
