"""Post-flatten scene overrides (`--scene-overrides FILE`).

A JSON file patches specific flattened TLAS instances without editing the
scene sources — a diagnostic/compat layer. Motivating case
(VALIDATION.md, veach forensics): the shipped pbrt ports of the Bitterli
scenes measurably diverge from the Tungsten originals that produced the
goldens (different backdrop albedo, different plate response); an
override file expresses the hypothesized Tungsten-compatible scene so
the divergence analysis can be *demonstrated* with one render instead of
argued from per-surface tables.

Schema::

    {
      "settings": {                       # optional render settings
        "mf_dist": "beckmann",            # microfacet distribution swap
        "max_depth": 2                    # cap the integrator depth
      },
      "instances": [
        {"index": 4,                       # tlas order (0-based)
         "matte_kd": [0.93, 0.93, 0.93]},  # replace material: matte
        {"index": 0,
         "metal": {"eta": [...], "k": [...],
                   "uroughness": 0.01, "vroughness": 0.01,
                   "remap": false,
                   "alpha_from_roughness": "square",
                   "fresnel_scale": [0.318, 0.318, 0.318]}},
        {"index": 7, "emission_scale": 0.5}  # scale an area light
      ]
    }

``alpha_from_roughness: "square"`` encodes Tungsten's perceptual
convention (alpha = roughness^2) by squaring before storing, with remap
forced off. Indices refer to the flattened instance order (Shape
directives, instancing replays included).

`--tungsten-compat` makes the shipped calibrations one flag:
`find_tungsten_overrides()` locates `docs/overrides/<scene>*.json`
(preferring the PNG-golden calibration) for the scene being rendered,
and the file's `settings` block carries the non-instance half of the
recipe (Beckmann lobes, direct-only depth) so no env vars are needed.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Union

import numpy as np

from . import types as T
from .flatten import FlatScene

_OVERRIDES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "docs", "overrides")


def find_tungsten_overrides(scene_path: str,
                            search_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Locate the shipped Tungsten-compat override file for a scene.

    Matches `<name>_tungsten*.json` in docs/overrides/ where `<name>`
    is a token of the scene's directory or file stem (so
    `.../veach-mis/scene.pbrt` finds `veach_tungsten_png.json`).
    PNG-golden calibrations (`*_png.json`) win over EXR ones — the
    shipped goldens are the PNGs."""
    d = search_dir or _OVERRIDES_DIR
    if not os.path.isdir(d):
        return None
    p = os.path.abspath(scene_path).lower()
    tokens = set()
    for part in (os.path.basename(os.path.dirname(p)),
                 os.path.splitext(os.path.basename(p))[0]):
        for tok in part.replace("-", " ").replace("_", " ").split():
            if tok and tok != "scene":
                tokens.add(tok)
    best = None
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".json") or "_tungsten" not in fn:
            continue
        name = fn.split("_tungsten")[0].lower()
        if name in tokens:
            cand = os.path.join(d, fn)
            if fn.endswith("_png.json"):
                return cand
            best = best or cand
    return best


def apply_overrides(scene: FlatScene, spec: Union[str, dict]) -> FlatScene:
    """Apply an override spec (path or dict) to a FlatScene in place."""
    base_dir = "."
    if isinstance(spec, str):
        base_dir = os.path.dirname(os.path.abspath(spec))
        with open(spec) as f:
            spec = json.load(f)
    bg = spec.get("background")
    if bg:
        if "color" in bg:
            scene.background_color = np.asarray(bg["color"], np.float32)
        if "mapname" in bg:
            # replace (or add) the infinite light's environment map —
            # the compat surface for scenes whose shipped assets are
            # missing (teapot's textures/envmap.pfm; the reconstruction
            # recipe lives in docs/overrides/)
            from .assets.images import load_image
            p = bg["mapname"]
            if not os.path.isabs(p):
                p = os.path.join(base_dir, p)
            img_idx = len(scene.images)
            scene.images.append(load_image(p))
            scene.background_texture = scene._push_texture(
                T.TEX_IMAGEMAP, [img_idx, 0, 0, 0], [0.0] * 4)
        if "matrix" in bg:
            m = np.asarray(bg["matrix"], np.float32).reshape(4, 4)
            scene.background_matrix = m
    settings = spec.get("settings", {})
    if "max_depth" in settings:
        scene.max_depth_hint = int(settings["max_depth"])
    if "mf_dist" in settings:
        # the distribution swap is read at trace time (microfacet.py);
        # the env var stays the mechanism, this is its file surface
        os.environ["RENE_MF_DIST"] = str(settings["mf_dist"])
    for ov in spec.get("instances", []):
        idx = int(ov["index"])
        if not 0 <= idx < len(scene.tlas):
            raise ValueError(
                f"override index {idx} out of range "
                f"(scene has {len(scene.tlas)} instances)")
        inst = scene.tlas[idx]
        if "matte_kd" in ov:
            ti = scene._push_texture(
                T.TEX_SOLID, [0, 0, 0, 0],
                [float(c) for c in ov["matte_kd"]][:3] + [0.0])
            mi = scene._push_material(T.MAT_MATTE, u0=[ti, 0, 0, 0])
            scene.tlas[idx] = dataclasses.replace(inst, material_index=mi)
        elif "metal" in ov:
            m = ov["metal"]
            ru = float(m.get("uroughness", 0.1))
            rv = float(m.get("vroughness", ru))
            if m.get("alpha_from_roughness") == "square":
                ru, rv = ru * ru, rv * rv
            te = scene._push_texture(
                T.TEX_SOLID, [0, 0, 0, 0],
                [float(c) for c in m["eta"]][:3] + [0.0])
            tk = scene._push_texture(
                T.TEX_SOLID, [0, 0, 0, 0],
                [float(c) for c in m["k"]][:3] + [0.0])
            tu = scene._push_texture(T.TEX_SOLID, [0, 0, 0, 0],
                                     [ru, ru, ru, 0.0])
            tv = scene._push_texture(T.TEX_SOLID, [0, 0, 0, 0],
                                     [rv, rv, rv, 0.0])
            fs = m.get("fresnel_scale")
            v0 = ([float(c) for c in fs][:3] + [0.0]) if fs \
                else (0.0, 0.0, 0.0, 0.0)
            mi = scene._push_material(
                T.MAT_METAL, u0=[te, tk, tu, tv],
                u1=[1 if m.get("remap", False) else 0, 0, 0, 0],
                v0=v0)
            scene.tlas[idx] = dataclasses.replace(inst, material_index=mi)
        if "emission_scale" in ov:
            ai = scene.tlas[idx].area_light_index
            if ai and scene.area_type[ai] != T.AREA_NULL:
                # clone the row (other instances may share it)
                scene.area_type.append(scene.area_type[ai])
                scene.area_color.append(
                    np.asarray(scene.area_color[ai], np.float32)
                    * float(ov["emission_scale"]))
                scene.tlas[idx] = dataclasses.replace(
                    scene.tlas[idx],
                    area_light_index=len(scene.area_type) - 1)
    return scene
