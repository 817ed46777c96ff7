"""Scenes past the immediates budget: mesh BVHs, shared-BLAS instances,
the sphere table and the light table (slices K1c and K1d).

* The plain BVH walk (ops/bvh.py) against brute force over every
  triangle, on seeded random rays: the same triangle except on exact-t
  ties, the same t, the same any-hit answers.
* `path_lanes_ref` against rene_tpu's megakernel in interpret mode
  (`make_pallas_batch_fn(..., interpret=True)`), per pixel, with the
  JAX packer's cluster width cut to 16 and its sphere-table blocks to 16
  slots so the interpret-mode compile stays short (`CLUSTER` and
  `SPH_BLOCK` only group the work; the hits are the same at any width,
  tests/test_pallas_cluster.py). Both draw the same xorshift32 stream
  from the same seeds (per 32x32 block in cluster mode), so every lane
  traces the same paths. What separates them: the BVH and the cluster
  march keep different triangles on exact-t ties at shared edges; XLA
  contracts multiply-adds where torch does not, and the sphere-table test
  (`_sph_test` :2620) subtracts two near-equal squares, so a first-hit
  normal moves by up to ~1e-3 where a ray grazes a far sphere; a rare
  lane crosses a branch the other way and follows another path. Limits:
  >= 99.5% of pixels' radiance and >= 99% of their normal and albedo sums
  agree (rene_tpu_torch.checks), image means within 1e-3 relative, ray
  totals within 0.1% on films of whole 32x32 blocks (the JAX `finish`
  also counts the duplicate lanes of partial edge blocks). Measured:
  radiance >= 99.92%, AOV >= 99.26% (the sphere table), means within
  6.0e-5, ray totals within 0.025%.
* The port's pixel-to-tile map against the JAX runner's lane layout.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import checks, kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.ops import bvh, rng
from rene_tpu_torch.scene import accel as A
from rene_tpu_torch.scene import pack as P

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SPP = 2

# the new scenes, cut to test size: (width, height) -> pbrt text
SCENES = {
    "mesh_materials": lambda w, h: scenes.mesh_materials_scene(w, h, 8, 6),
    "instanced": lambda w, h: scenes.instanced_scene(w, h),
    "sphere_table": lambda w, h: scenes.sphere_light_scene(w, h, 100, 1, 3),
    "light_table": lambda w, h: scenes.sphere_light_scene(w, h, 8, 24, 4),
}
# environment switches of the JAX kernel, pinned to its defaults
JAX_ENV_OFF = ("RENE_MF_DIST", "RENE_MEGA_PACK", "RENE_MESH_TEST",
               "RENE_CONST_DIR", "RENE_SPH_ANY", "RENE_SUB_TRIS",
               "RENE_SUB_GATE", "RENE_CLUSTER_ORDER")


def buffers(name, width=128, height=64):
    src = SCENES[name](width, height)
    return build_device_scene(create_scene(parse_pbrt(src), "/tmp"))


def _jax_env(mp):
    from rene_tpu.integrators import pallas_path as pp
    mp.setattr(pp, "CLUSTER", 16)
    mp.setattr(pp, "SPH_BLOCK", 16)
    mp.setenv("RENE_QUAD_FUSE", "0")
    for k in JAX_ENV_OFF:
        mp.delenv(k, raising=False)
    return pp


@pytest.fixture(scope="module")
def jax_run():
    """run(name, width, height, seed) -> (buffers, config, JAX result),
    each scene's interpret-mode megakernel compiled at its first call."""
    runs = {}

    def get(name, width, height, seed):
        with pytest.MonkeyPatch.context() as mp:
            pp = _jax_env(mp)
            key = (name, width, height)
            if key not in runs:
                bn, cfg = buffers(name, width, height)
                runs[key] = (bn, cfg, pp.make_pallas_batch_fn(
                    bn, cfg, interpret=True))
            bn, cfg, run = runs[key]
            return bn, cfg, run(seed, SPP)
    return get


@pytest.mark.parametrize("name,width,height,seed", [
    ("mesh_materials", 128, 64, 7), ("mesh_materials", 128, 64, 1234567),
    ("instanced", 128, 64, 7), ("sphere_table", 128, 64, 7),
    ("light_table", 128, 64, 7), ("mesh_materials", 144, 80, 7)])
def test_plain_version_matches_interpret_megakernel(jax_run, name, width,
                                                    height, seed):
    bn, cfg, res = jax_run(name, width, height, seed)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    assert tabs["has_accel"] == (name != "light_table")
    out = M.path_lanes_ref(tabs, seed, SPP).numpy()
    assert np.isfinite(out).all()
    if width % 32 or height % 32:
        # partial edge blocks: radiance only, no ray totals
        a = checks.agreement(out[:3], np.array(res["radiance"]).T)
        assert a["rad_frac"] >= 0.995, a
        assert a["mean_rel"] <= 1e-3, a
        return
    ref = np.concatenate([np.array(res[k]).T for k in
                          ("radiance", "normal", "albedo")])
    a = checks.agreement(out[:9], ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.99, a
    assert a["mean_rel"] <= 1e-3, a
    jax_rays = float(res["rays"])
    assert abs(out[9].sum() - jax_rays) <= 1e-3 * jax_rays


def test_tile_map_matches_jax_runner(monkeypatch):
    """Lane l of the JAX runner's layout (`px_host`/`py_host`) lies in
    grid step l // 1024; the port's `rng.tile_of` gives its pixel that
    step, on a film with partial edge blocks."""
    pp = _jax_env(monkeypatch)
    bn, cfg = buffers("mesh_materials", 144, 80)
    run = pp.make_pallas_batch_fn(bn, cfg, interpret=True)
    px = run.px_host.reshape(-1).astype(np.int64)
    py = run.py_host.reshape(-1).astype(np.int64)
    lanes = np.arange(px.size)
    step = lanes // (run.tile_sub * 128)
    mine = rng.tile_of(torch.from_numpy(py * 144 + px), 144, True).numpy()
    np.testing.assert_array_equal(mine, step)
    assert run.n_tiles == 5 * 3
    # scenes within the immediates budget keep the 8192-lane steps
    tabs = M.device_tables(P.pack_tables(*buffers("light_table")), "cpu")
    assert not tabs["block_seed"]


def _random_mesh(n, seed):
    g = np.random.default_rng(seed)
    c = g.uniform(-1.0, 1.0, (n, 1, 3))
    p = c + g.normal(0.0, 0.15, (n, 3, 3))
    # a few shared edges, where exact-t ties happen
    p[1::7, 0] = p[0:-1:7, 1][:p[1::7].shape[0]]
    p[1::7, 1] = p[0:-1:7, 2][:p[1::7].shape[0]]
    return p


@pytest.mark.parametrize("seed", [0, 1])
def test_bvh_walk_matches_brute_force(seed):
    p = _random_mesh(600, seed)
    b = A._Builder()
    root = b.add(p, np.zeros_like(p), np.zeros(p.shape[0]))
    tabs = {"nodes": torch.from_numpy(np.concatenate(b.nodes)).float(),
            "mesh": torch.from_numpy(np.concatenate(b.rows)).float(),
            "bvh_depth": b.depth, "max_leaf": b.max_leaf}
    g = np.random.default_rng(100 + seed)
    n = 4096
    o = g.uniform(-2.0, 2.0, (n, 3))
    d = g.uniform(-1.0, 1.0, (n, 3)) - 0.3 * o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                for a in (*o.T, *d.T))
    tmin, tmax = 1e-3, 1.5

    best = {"t": torch.full((n,), bvh.BIG), "u": torch.zeros(n),
            "v": torch.zeros(n), "prim": torch.full((n,), -1)}
    done = torch.zeros(n, dtype=torch.bool)
    bvh.march(tabs, root, ray, tmin, None, best, done)
    anyh = bvh.march(tabs, root, ray, tmin, tmax, None, done)

    rows = tabs["mesh"]
    t, u, v, ok = bvh.mt_test(rows, *(x[:, None] for x in ray))
    tc = torch.where(ok & (t >= tmin), t, np.inf)
    t_ref, p_ref = tc.min(dim=1)
    hit_ref = t_ref < bvh.BIG
    assert bool(hit_ref.any()) and bool((~hit_ref).any())
    hit = best["prim"] >= 0
    assert torch.equal(hit, hit_ref)
    torch.testing.assert_close(best["t"][hit], t_ref[hit], rtol=1e-6, atol=0)
    same = best["prim"] == p_ref
    # a different triangle only on an exact tie
    assert torch.equal(best["t"][hit & ~same], t_ref[hit & ~same])
    assert (same | ~hit).float().mean() > 0.99
    any_ref = (ok & (t >= tmin) & (t <= tmax)).any(dim=1)
    assert torch.equal(anyh, any_ref)
    assert bool(anyh.any()) and bool((~anyh).any())


def test_sphere_table_matches_brute_force():
    bn, cfg = buffers("sphere_table")
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    tab = tabs["sph_tab"]
    assert tab.shape[0] == A.SPH_BLOCK and int((tab[:, 3] > 0).sum()) == 100
    g = np.random.default_rng(3)
    n = 2048
    o = g.uniform(-6.0, 6.0, (n, 3)) * [1, 1, 0.3] + [0, 0, 2.0]
    d = g.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                for a in (*o.T, *d.T))
    big = torch.full((n,), bvh.BIG)
    t, nx, ny, nz, mat, _, _ = bvh.sphere_table_closest(tabs, *ray, 1e-3,
                                                         big)
    ts, ok = bvh._sph_test(tab, *(x[:, None] for x in ray), 1e-3)
    t_ref, k = torch.where(ok, ts, np.inf).min(dim=1)
    hit = t_ref < bvh.BIG
    assert bool(hit.any()) and bool((~hit).any())
    assert torch.equal(t < bvh.BIG, hit)
    torch.testing.assert_close(t[hit], t_ref[hit], rtol=0, atol=0)
    torch.testing.assert_close(mat[hit], tab[k[hit], A.SPHT_MAT].long())
    nrm = torch.stack([nx, ny, nz])[:, hit].norm(dim=0)
    torch.testing.assert_close(nrm, torch.ones_like(nrm), rtol=1e-3, atol=0)
    anyh = bvh.sphere_table_any(tabs, *ray, 1e-3, 3.0,
                                torch.zeros(n, dtype=torch.bool))
    assert torch.equal(anyh, (ok & (ts <= 3.0)).any(dim=1))


def test_split_and_tables():
    """What goes where: emissive triangles stay immediates with their
    emit objects pointing at their rows; the instanced sphere is one
    shared BLAS with one row per instance; table spheres leave the
    emissive sphere and the ellipsoid as immediates."""
    bn, cfg = buffers("instanced")
    tb = P.pack_tables(bn, cfg)
    assert cfg.num_triangles > P.MAX_TRIS
    assert tb.tris.shape[0] == 2 and tb.emit_tris.tolist() == [0, 1]
    assert tb.emit_objects[0, P.EO_START] == 0
    assert tb.insts.shape == (12, A.INST_W) and tb.world_root >= 0
    assert tb.mesh.shape[0] == 2 + (cfg.num_triangles - 2 - 2) // 12
    _, _, shared = P.split_triangles(bn, cfg)
    assert len(shared) == 1 and len(shared[0][1]) == 12
    roots = set(tb.insts[:, A.INST_ROOT].tolist())
    assert len(roots) == 1 and roots != {tb.world_root}
    np.testing.assert_array_equal(
        tb.insts[:, :12], bn["inst_w2o"][shared[0][1]].reshape(12, 12))
    assert tb.block_seed and tb.has_accel

    bn, cfg = buffers("sphere_table")
    tb = P.pack_tables(bn, cfg)
    assert tb.spheres.shape[0] == 2 and tb.emit_spheres.tolist() == [1]
    assert tb.nodes.shape[0] == 0 and not tb.block_seed and tb.has_accel
    real = tb.sph_tab[:, A.SPHT_R] > 0
    for b in range(tb.sph_box.shape[0]):
        rows = tb.sph_tab[b * A.SPH_BLOCK:(b + 1) * A.SPH_BLOCK]
        rows = rows[real[b * A.SPH_BLOCK:(b + 1) * A.SPH_BLOCK]]
        assert (tb.sph_box[b, 0:3] <= (rows[:, 0:3] - rows[:, 3:4]).min(0)
                ).all()
        assert (tb.sph_box[b, 4:7] >= (rows[:, 0:3] + rows[:, 3:4]).max(0)
                ).all()

    bn, cfg = buffers("light_table")
    tb = P.pack_tables(bn, cfg)
    assert tb.lights.shape[0] == 24 > P.MAX_LIGHTS
    assert tb.light_dots.shape == (24, tb.tris.shape[0], 4)
    assert not tb.has_accel


def test_renders_mesh_scene_without_jax(tmp_path):
    """With jax and rene_tpu blocked, the port packs a mesh scene and
    renders it on the CPU through its CLI."""
    scene = tmp_path / "s.pbrt"
    scene.write_text(scenes.mesh_materials_scene(16, 8, 8, 6))
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["rene_tpu"] = None
        import rene_tpu_torch.cli
        from rene_tpu_torch.scene import build_device_scene, load_scene
        from rene_tpu_torch.scene.pack import pack_tables
        tables = pack_tables(*build_device_scene(load_scene({str(scene)!r})))
        assert tables.has_accel and tables.mesh.shape[0] == 644
        rc = rene_tpu_torch.cli.main([{str(scene)!r}, "--device", "cpu",
                                      "--spp", "1", "--output",
                                      {str(tmp_path / "o.png")!r}])
        assert rc == 0
        assert not any(m.split(".")[0] in ("jax", "rene_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mesh_materials", "instanced",
                                  "sphere_table", "light_table"])
def test_kernel_on_card_matches_plain_version(name):
    """On a CUDA card: the mesh variant against its plain version, 4 spp,
    at the card's limits (chip_smoke.py phase 6 runs the same check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*buffers(name)), "cuda")
    before = dict(kernels.launches)
    out = kernels.mega_path(tabs, 1234567, 4)
    ref = M.path_lanes_ref(tabs, 1234567, 4)
    torch.cuda.synchronize()
    variant = kernels.variant(tabs)
    assert kernels.launches[variant] == before[variant] + 1
    checks.check_card(checks.agreement(out.cpu(), ref.cpu()),
                      f"{name} 128x64 x 4 spp")
