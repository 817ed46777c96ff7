"""The port's scene frontend: no jax, tables equal to the JAX packer's.

Exact equality throughout: both packers compute the same float64
expressions from the same float32 buffers, and the tables are their
float32 casts.
"""
import re
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
from rene_tpu_torch import scenes
from rene_tpu_torch.scene import pack as P

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _scene(src, base="/tmp"):
    return build_device_scene(create_scene(parse_pbrt(src), str(base)))


def test_imports_and_renders_without_jax(tmp_path):
    """With jax and rene_tpu blocked, every module of the port imports,
    packs a scene and renders it on the CPU through its CLI, with both
    engines: the Cornell box, a textured scene and a volpath fog
    scene."""
    scene = tmp_path / "s.pbrt"
    scene.write_text(scenes.cornell_box(16, 8))
    textured = tmp_path / "t.pbrt"
    textured.write_text(scenes.textured("tex_image", tmp_path, 16, 8))
    fog = tmp_path / "f.pbrt"
    fog.write_text(scenes.fog_scene(16, 8))
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["rene_tpu"] = None
        import rene_tpu_torch
        for m in pkgutil.walk_packages(rene_tpu_torch.__path__,
                                       "rene_tpu_torch."):
            importlib.import_module(m.name)
        import rene_tpu_torch.cli
        from rene_tpu_torch.scene import build_device_scene, load_scene
        from rene_tpu_torch.scene.pack import pack_tables
        bn, cfg = build_device_scene(load_scene({str(scene)!r}))
        tables = pack_tables(bn, cfg)
        assert tables.tris.shape == (32, {P.TRI_W})
        for engine in ("pallas", "wave"):
            rc = rene_tpu_torch.cli.main([{str(scene)!r}, "--device", "cpu",
                                          "--spp", "1", "--engine", engine,
                                          "--output",
                                          {str(tmp_path / "o.png")!r}])
            assert rc == 0
            # textured materials, an env-map background and its light
            # sampling
            rc = rene_tpu_torch.cli.main([{str(textured)!r}, "--device",
                                          "cpu", "--spp", "1", "--engine",
                                          engine, "--output",
                                          {str(tmp_path / "t.png")!r}])
            assert rc == 0
            # the volpath body: a medium, its interfaces, the march
            rc = rene_tpu_torch.cli.main([{str(fog)!r}, "--device", "cpu",
                                          "--spp", "1", "--engine", engine,
                                          "--output",
                                          {str(tmp_path / "f.png")!r}])
            assert rc == 0
        bn, cfg = build_device_scene(load_scene({str(textured)!r}))
        tables = pack_tables(bn, cfg)
        assert tables.has_tex and tables.has_env and tables.atlas.size > 512
        assert not any(m.split(".")[0] in ("jax", "rene_tpu")
                       for m, v in sys.modules.items() if v is not None)
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")
    assert all((tmp_path / f).exists() for f in ("o.png", "t.png", "f.png"))


def test_port_sources_import_no_jax_package():
    """No module of the port, and not chip_smoke.py, imports jax or
    rene_tpu: the port keeps its own copy of the frontend."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|rene_tpu)\b", re.M)
    files = sorted((REPO / "rene_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 30
    for f in files:
        assert not pat.search(f.read_text()), f


# the frontend files the port copied from rene_tpu, with the lines that
# may differ: docstrings naming the reference's sources, logger names,
# relative imports, and to_torch in place of to_jax
COPIED = ("pbrt/__init__.py", "pbrt/ast.py", "pbrt/include.py",
          "pbrt/parser.py", "scene/types.py", "scene/intermediate.py",
          "scene/flatten.py", "scene/overrides.py", "scene/assets/images.py",
          "scene/assets/ply.py", "scene/assets/spectrum.py",
          "scene/assets/subdivision.py", "ops/rgb9e5.py")


def _wave_src():
    from .test_wave import SRC
    return SRC


@pytest.mark.parametrize("name", [
    "cornell_box", "materials_scene", "mesh_materials_scene",
    "instanced_scene", "sphere_light_scene", "big_mesh_scene", "test_wave",
    "fog_scene", "fog_env_scene", "fog_mesh_scene"]
    + list(scenes.TEXTURED))
def test_frontend_copy_matches_reference(name, tmp_path):
    """The port's copy of the frontend (pbrt parser, scene flattening,
    build_device_scene) gives the reference's buffers and RenderConfig on
    every inline scene, the image atlas and the env-map sampling tables of
    the textured ones included, and the media and medium interfaces of
    the fog scenes: equal dtypes, shapes and values. The big mesh runs at
    a 64x36 film (the film size does not touch the mesh)."""
    from rene_tpu_torch.pbrt import parse_pbrt as parse_port
    from rene_tpu_torch.scene import build_device_scene as build_port
    from rene_tpu_torch.scene import create_scene as create_port
    if name == "test_wave":
        src = _wave_src()
    elif name == "big_mesh_scene":
        src = scenes.big_mesh_scene(64, 36)
    elif name in scenes.TEXTURED:
        src = scenes.textured(name, tmp_path, 64, 32)
    elif name == "fog_env_scene":
        src = scenes.fog_env_scene(tmp_path, 64, 32)
    elif name == "fog_mesh_scene":
        src = scenes.fog_mesh_scene(64, 32, small=True)
    else:
        src = getattr(scenes, name)(64, 32)
    bn_ref, cfg_ref = _scene(src, tmp_path)
    bn, cfg = build_port(create_port(parse_port(src), str(tmp_path)))
    if name.startswith("fog"):
        assert cfg.integrator == "volpath" and cfg.has_media
        assert (bn["inst_interior"] != 0).any()
    if name in scenes.TEXTURED:
        assert bn["img_atlas"].shape[0] >= 512
        assert cfg.env_nee == (name in ("tex_image", "env", "env_emitter",
                                        "textured_mesh"))
    assert sorted(bn) == sorted(bn_ref)
    for k in bn_ref:
        assert bn[k].dtype == bn_ref[k].dtype, k
        assert np.array_equal(bn[k], bn_ref[k]), k
    assert repr(cfg) == repr(cfg_ref)


def test_copied_sources_match_reference():
    """Each copied module equals its original up to at most three lines
    that name the package or the reference's sources."""
    for rel in COPIED:
        mine = (REPO / "rene_tpu_torch" / rel).read_text().splitlines()
        ref = (REPO / "rene_tpu" / rel).read_text().splitlines()
        assert len(mine) == len(ref), rel
        diff = [(a, b) for a, b in zip(mine, ref) if a != b]
        assert len(diff) <= 3, (rel, diff)
        for a, b in diff:
            # a source path of the reference, made relative
            b = re.sub(r"\(/[\w/]*?reference/", "(", b)
            assert a == b or "rene" in a + b, (rel, a, b)


def test_mat_fetches_copy_matches_reference():
    from rene_tpu.ops.bsdf import _MAT_FETCHES
    assert P._MAT_FETCHES == _MAT_FETCHES


def test_layout_header_matches_pack_constants():
    """csrc/layout.cuh, scene/pack.py, scene/accel.py and
    integrators/wave.py describe the same rows."""
    text = (REPO / "rene_tpu_torch" / "csrc" / "layout.cuh").read_text()
    defs = dict(re.findall(r"#define (\w+) (-?\d+)\s*$", text, re.M))
    from rene_tpu_torch.integrators import wave as WV
    from rene_tpu_torch.scene import accel as A
    from rene_tpu_torch.scene import types as T
    owner = {n: m for m in (T, A, P, WV) for n in defs if hasattr(m, n)}
    assert set(owner) == set(defs)
    assert {n for n in defs if hasattr(A, n)} >= {"NODE_W", "MESH_W",
                                                   "INST_W", "SPH_BLOCK"}
    # the volpath body's: material slots, the media rows, the medium row
    assert {"MAT_IMED", "MAT_EMED", "MED_ST", "MED_SS", "MED_G", "MED_VAC",
            "MED_W", "WROW_MED"} <= set(owner)
    for name, module in owner.items():
        assert int(defs[name]) == getattr(module, name), name


@pytest.fixture(scope="module")
def materials():
    return _scene(scenes.materials_scene())


def test_records_match_pack_scene(materials, monkeypatch):
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    from rene_tpu.integrators.pallas_path import pack_scene
    bn, cfg = materials
    ps = pack_scene(bn, cfg)
    tris, spheres, emit_objects, lights = P.pack_records(bn, cfg)
    assert len(tris) == len(ps.tris) == 6
    assert len(spheres) == len(ps.spheres) == 8
    assert {r["mat_type"] for r in spheres} == set(range(8))
    for mine, ref in zip(tris + spheres, ps.tris + ps.spheres):
        for key, val in mine.items():
            if key == "mat_id":
                continue
            assert np.array_equal(np.asarray(val), np.asarray(ref[key])), key
    assert [e["kind"] for e in emit_objects] == \
        [e["kind"] for e in ps.emit_objects]
    for mine, ref in zip(emit_objects, ps.emit_objects):
        if ref["kind"] == "sphere":
            assert mine["o2w"] == ref["o2w"]
        else:
            prims = [tuple(tuple(v) for v in bn["tri_p"][i].astype(float))
                     for i in range(mine["start"],
                                    mine["start"] + mine["count"])]
            assert prims == ref["prims"]
    assert lights == ps.lights


def test_tables_are_float32_casts_of_records(materials):
    bn, cfg = materials
    tb = P.pack_tables(bn, cfg)
    tris, spheres, _, lights = P.pack_records(bn, cfg)
    for i, r in enumerate(tris):
        row = tb.tris[i]
        for key, off in (("m0", P.TRI_M0), ("e2", P.TRI_E2), ("pn", P.TRI_PN),
                         ("n1", P.TRI_N1), ("gn_unit", P.TRI_GN),
                         ("v2", P.TRI_V2)):
            np.testing.assert_array_equal(row[off:off + 3],
                                          np.float32(r[key]))
        assert row[P.TRI_PK] == np.float32(r["pk"])
        assert row[P.TRI_MAT] == r["mat_id"]
        emit = np.float32(r["emit"]) if r["emissive"] else np.zeros(3)
        np.testing.assert_array_equal(row[P.TRI_EMIT:P.TRI_EMIT + 3], emit)
    for s, r in enumerate(spheres):
        np.testing.assert_array_equal(tb.spheres[s, :12],
                                      np.float32(r["w2o"]).reshape(-1))
        m = tb.mats[r["mat_id"]]
        assert m[P.MAT_TYPE] == r["mat_type"]
        np.testing.assert_array_equal(m[P.MAT_ALPHA:P.MAT_ALPHA + 2],
                                      np.float32(r["alpha"]))
    assert tb.emit_tris.tolist() == [4, 5]
    assert tb.lights.shape == (1, P.LIGHT_W) and len(lights) == 1
    assert tb.light_dots.shape == (1, 6, 4)
    assert tb.max_depth == 16 and tb.use_rr
    assert tb.cam[P.CAM_FILTER] == 1.0


_QUAD = ('Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
         '"point P" [-1 -1 0 1 -1 0 1 1 0 -1 1 0]')


def _grid(n):
    """A mesh of 2 n^2 triangles."""
    pts, idx = [], []
    for j in range(n + 1):
        for i in range(n + 1):
            pts += [i / n, j / n, 0.0]
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            idx += [a, a + 1, a + n + 2, a, a + n + 2, a + n + 1]
    return ('Shape "trianglemesh" "integer indices" [{}] "point P" [{}]'
            .format(" ".join(map(str, idx)), " ".join(map(str, pts))))


_HEAD = 'Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'


@pytest.mark.parametrize("src,item", [
    (_HEAD + 'WorldBegin\nTexture "c" "spectrum" "checkerboard"\n'
     'Material "metal" "texture eta" "c"\n' + _QUAD + "\nWorldEnd", "K1b"),
    (_HEAD + "WorldBegin\n" + 'AreaLightSource "diffuse" "rgb L" [1 1 1]\n'
     + _grid(17) + "\nWorldEnd", "K1c"),
    (_HEAD + "WorldBegin\n" + "\n".join(
        f'AttributeBegin\nTranslate {i} 0 0\nScale 1 2 1\nShape "sphere" '
        f'"float radius" 0.1\nAttributeEnd' for i in range(65))
     + "\nWorldEnd", "K1d"),
    (_HEAD + "WorldBegin\n" + "\n".join(
        f'LightSource "distant" "point from" [1 0 {i + 2}]'
        for i in range(1025)) + "\n" + _QUAD + "\nWorldEnd", "K1d"),
], ids=["textured", "big_mesh", "many_spheres", "many_lights"])
def test_slice_supported_rejects(src, item):
    bn, cfg = _scene(src)
    with pytest.raises(NotImplementedError, match=item):
        P.slice_supported(bn, cfg)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        P.slice_supported(bn, cfg)


@pytest.mark.parametrize("integrator", ["path", "volpath"])
def test_slice_supported_accepts_sobol(integrator):
    """`Sampler "sobol"` scenes, path and volpath, are taken, as the JAX
    package's `pallas_eligible` takes them, and their tables carry the
    sampler."""
    from rene_tpu.integrators.pallas_path import pallas_eligible
    src = (f'Integrator "{integrator}"\nSampler "sobol"\n' + _HEAD
           + "WorldBegin\n" + _QUAD + "\nWorldEnd")
    bn, cfg = _scene(src)
    assert cfg.sampler == "sobol" and cfg.integrator == integrator
    P.slice_supported(bn, cfg)
    assert pallas_eligible(bn, cfg)
    assert P.pack_tables(bn, cfg).sobol


def test_slice_supported_accepts_main_path_scenes():
    """The K1a scenes, and scenes past 512 triangles (a world mesh and
    shared-BLAS instances), 64 spheres and 16 distant lights that the JAX
    package's `pallas_eligible` takes."""
    from rene_tpu.integrators.pallas_path import pallas_eligible
    for src in (scenes.cornell_box(8, 8), scenes.materials_scene(8, 8),
                _HEAD + "WorldBegin\n" + _grid(17) + "\nWorldEnd",
                scenes.mesh_materials_scene(8, 8),
                scenes.instanced_scene(8, 8),
                scenes.sphere_light_scene(8, 8, 100, 24)):
        bn, cfg = _scene(src)
        P.slice_supported(bn, cfg)
        assert pallas_eligible(bn, cfg)


# -- textures (K1b) ------------------------------------------------------------
def _inline_scenes(directory):
    """(name, pbrt text) of every inline scene of the port, the textured
    ones with their images written to `directory`, and of scenes the
    kernels refuse."""
    out = [(n, getattr(scenes, n)(8, 8)) for n in (
        "cornell_box", "materials_scene", "mesh_materials_scene",
        "instanced_scene")]
    out.append(("sphere_light_scene", scenes.sphere_light_scene(8, 8, 100,
                                                                 24)))
    out += [(n, scenes.textured(n, directory, 8, 8))
            for n in scenes.TEXTURED]
    (directory / "kd.pfm").write_bytes(
        (directory / "t_floor.pfm").read_bytes())
    tex = ('Texture "kdmap" "spectrum" "imagemap" "string filename" '
           '"kd.pfm"\n')
    refused = {
        "checker_of_imagemap": tex + 'Texture "c" "spectrum" "checkerboard" '
        '"texture tex1" "kdmap" "rgb tex2" [.7 .7 .7]\n'
        'Material "matte" "texture Kd" "c"\n',
        "metal_k_texture": tex + 'Material "metal" "texture k" "kdmap"\n',
        "scaled_opacity": tex + 'Texture "s" "spectrum" "scale" '
        '"texture tex1" "kdmap" "rgb tex2" [.5 .5 .5]\n'
        'Material "uber" "texture opacity" "s"\n',
        "plastic_roughness_texture": 'Texture "r" "float" "imagemap" '
        '"string filename" "kd.pfm"\n'
        'Material "plastic" "texture roughness" "r"\n',
        "scale_of_two_imagemaps": tex + 'Texture "s" "spectrum" "scale" '
        '"texture tex1" "kdmap" "texture tex2" "kdmap"\n'
        'Material "matte" "texture Kd" "s"\n',
    }
    out += [(n, _HEAD + "WorldBegin\n" + body + _QUAD + "\nWorldEnd")
            for n, body in refused.items()]
    out.append(("checker_of_imagemap_background",
                _HEAD + "WorldBegin\n" + tex
                + 'Texture "c" "spectrum" "checkerboard" "texture tex1" '
                '"kdmap"\nLightSource "infinite" "texture L" ["c"]\n'
                + _QUAD + "\nWorldEnd"))
    # the volpath scenes, and a path scene with a medium (whose path body
    # ignores it)
    out += [("fog_scene", scenes.fog_scene(8, 8)),
            ("fog_env_scene", scenes.fog_env_scene(directory, 8, 8)),
            ("fog_mesh_scene", scenes.fog_mesh_scene(8, 8, small=True)),
            ("path_scene_with_medium", _HEAD + "WorldBegin\n" + scenes.FOG
             + '\nAttributeBegin\nMediumInterface "fog" ""\n'
             'Material "none"\nShape "sphere" "float radius" 2\n'
             "AttributeEnd\n" + _QUAD + "\nWorldEnd")]
    return out


def test_slice_supported_agrees_with_pallas_eligible(tmp_path):
    """`slice_supported` takes exactly the scenes the reference's
    `pallas_eligible` takes among the textured ones, the volpath fog
    scenes and a path scene with a medium (the port's Sobol refusal, and
    the reference's VMEM texel caps, aside), and names K1b for the
    others."""
    from rene_tpu.integrators.pallas_path import pallas_eligible
    verdicts = {}
    for name, src in _inline_scenes(tmp_path):
        bn, cfg = _scene(src, tmp_path)
        try:
            P.slice_supported(bn, cfg)
            mine = True
        except NotImplementedError as e:
            assert "K1b" in str(e), (name, e)
            mine = False
        assert mine == pallas_eligible(bn, cfg), name
        verdicts[name] = mine
    assert sum(verdicts.values()) == 9 + len(scenes.TEXTURED)
    assert not any(v for n, v in verdicts.items()
                   if n not in scenes.TEXTURED and "_scene" not in n
                   and n != "cornell_box")
    assert verdicts["path_scene_with_medium"] and verdicts["fog_mesh_scene"]


@pytest.mark.parametrize("name", ["tex_image", "tex_scale", "tex_checker",
                                  "textured_mesh"])
def test_atlas_and_descriptors_match_pack_scene(name, tmp_path, monkeypatch):
    """The port's flat RGB9E5 atlas decodes, image by image, to the texels
    of the JAX packer's paged `img_table`; each material's slot
    descriptors are `_mat_slot_descs`'s and its table row holds them; the
    background and the uv rows are `pack_scene`'s."""
    monkeypatch.setenv("RENE_QUAD_FUSE", "0")
    monkeypatch.delenv("RENE_IMG_PACK", raising=False)
    from rene_tpu.integrators import pallas_path as pp
    from rene_tpu.ops import rgb9e5
    monkeypatch.setattr(pp, "CLUSTER", 16)
    bn, cfg = _scene(scenes.textured(name, tmp_path, 16, 16), tmp_path)
    ps = pp.pack_scene(bn, cfg)
    tb = P.pack_tables(bn, cfg)
    atlas, offsets = P.pack_atlas(bn)
    assert np.array_equal(atlas, tb.atlas) and atlas.dtype == np.uint32
    used = pp._kernel_images(bn, cfg)
    assert P.kernel_images(bn) == used and len(used) >= 1
    table = np.asarray(ps.img_table).view(np.uint32).reshape(-1)
    row = 0
    for ii in used:
        n = int(bn["img_width"][ii]) * int(bn["img_height"][ii])
        mine = rgb9e5.decode(atlas[offsets[ii]:offsets[ii] + n])
        ref = rgb9e5.decode(table[row * 128:row * 128 + n])
        np.testing.assert_array_equal(mine, ref)
        np.testing.assert_array_equal(
            mine, bn["img_atlas"][int(bn["img_offset"][ii]):][:n, :3])
        row += (n + 127) // 128
    n_tex = 0
    for m in sorted(set(bn["inst_material"].tolist())):
        descs = pp._mat_slot_descs(bn, m)
        assert P.mat_slot_descs(bn, m) == descs
        ref = pp._mat_record(bn, m)
        rec = P.mat_record(bn, m)
        assert rec["texs"] == ref["texs"] and rec["rrm"] == ref["rrm"]
        for key in ("albedo", "k", "alpha", "op", "kr2", "kt2"):
            assert tuple(rec[key]) == tuple(ref[key]), (m, key)
        r = tb.mats[m]
        assert r[P.MAT_NTEX] == len(rec["texs"])
        for cls, d in rec["texs"].items():
            o = P.MAT_TEX + P.IMG_CLASSES.index(cls) * P.TEXD_W
            if d[0] == "checker":
                assert r[o] == P.TEXK_CHECKER
                np.testing.assert_array_equal(
                    r[o + 1:o + 9], np.float32([d[1], d[2], *d[3], *d[4]]))
            else:
                ii = d[1]
                assert tuple(r[o:o + 4]) == (
                    P.TEXK_IMAGE, offsets[ii], bn["img_width"][ii],
                    bn["img_height"][ii])
            n_tex += 1
    assert n_tex >= 2
    # the background: constant, image or checker, and its matrices
    np.testing.assert_array_equal(tb.cam[P.CAM_BG:P.CAM_BG + 3],
                                  np.float32(ps.background))
    if ps.bg_img is not None:
        ii = pp._tex_kernel_desc(bn, int(bn["background_texture"]))[1]
        assert tb.bg_kind == P.BG_IMAGE
        assert tuple(tb.cam[P.CAM_BG_IMG:P.CAM_BG_IMG + 3]) == (
            offsets[ii], ps.bg_img[1], ps.bg_img[2])
    elif ps.bg_checker is not None:
        us, vs, ev, od = ps.bg_checker
        assert tb.bg_kind == P.BG_CHECKER
        np.testing.assert_array_equal(tb.cam[P.CAM_BG_CHK:P.CAM_BG_CHK + 8],
                                      np.float32([us, vs, *ev, *od]))
    np.testing.assert_array_equal(
        tb.cam[P.CAM_BG_MAT:P.CAM_BG_MAT + 9].reshape(3, 3),
        np.float32(ps.bg_matrix[:3, :3]))
    np.testing.assert_array_equal(
        tb.cam[P.CAM_BG_INV:P.CAM_BG_INV + 9].reshape(3, 3),
        np.float32(ps.bg_matrix_inv[:3, :3]))
    assert tb.has_env == (ps.env_tab is not None)
    if tb.has_env:
        np.testing.assert_array_equal(tb.env_ccdf.T, ps.env_tab[:128, :64])
        np.testing.assert_array_equal(tb.env_pdf, ps.env_tab[128:192])
        np.testing.assert_array_equal(tb.env_mcdf, ps.env_tab[192, :64])
    # uv: the immediates' per vertex, the mesh's as uv0 and two deltas
    for mine, ref in zip(tb.tris, ps.tris):
        np.testing.assert_array_equal(
            mine[P.TRI_UV0:P.TRI_UV0 + 6],
            np.float32([*ref["uv0"], *ref["uv1"], *ref["uv2"]]))
    if name == "textured_mesh":
        imm, rest, shared = P.split_triangles(bn, cfg)
        assert np.array_equal(np.nonzero(pp._immediate_tri_mask(bn)[
            :cfg.num_triangles])[0], imm)
        assert tb.mesh_uv.shape == (tb.mesh.shape[0], 6) and shared
        assert tb.mesh_uv.min() >= -1.0 and tb.mesh_uv.max() <= 1.0
        assert tb.mesh_uv.std() > 0.01
    else:
        assert tb.mesh_uv.shape == (0, 6)
