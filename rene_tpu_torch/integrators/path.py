"""The XLA engine's surface path tracer (rene_tpu/integrators/path.py).

Every lane owns one pixel and streams its samples back to back: a path
that ends is replaced at once by the pixel's next camera path (path
regeneration). The reference runs the bounce loop as a `lax.while_loop`
over the whole batch; here it is a Python loop that runs while any lane
has samples left, each iteration a bounce of every lane, masked where a
lane is done. Per bounce:

  1. the closest hit (ops/intersect.py `trace`); the background on a miss;
  2. the lobe slots of the hit's material, the one-sided emitter's
     radiance, the normal and albedo AOVs at depth 0;
  3. NEE toward every distant light (a shadow cast each);
  4. with emitters (or an importance-sampled env map) and a diffuse
     lobe, the 50/50 mixture of emitter sampling and BSDF sampling, the
     light's pdf from a cast against the emissive set; else BSDF
     sampling;
  5. the path ends on a zero throughput or a pdf under 1e-5; Russian
     roulette past depth 12 (where maxdepth allows it); the depth cut.

Every lane draws on every iteration, live or not, in the reference's
order (the BSDF's lobe pick where it has more than one slot and its
three draws, the coin, the emitter, the env pick, roulette, then the
camera ray of a regenerated path), so each pixel's stream
pcg_init(pix ^ seed) is the reference's draw for draw. The XLA engine
takes no `Sampler "sobol"`: the independent PCG32si stream always, as in
the reference, whose XLA integrators import no sampler.

A throughput whose channels are all below float32's normal range counts
as zero and ends the path, as under the flush-to-zero arithmetic of XLA
and the TPU (torch keeps subnormals on the CPU and on the card).

The ray count of an iteration is active lanes x (1 + lights + (emitters
> 0)), the reference's nominal count.
"""
from __future__ import annotations

import torch

from ..ops import bsdf as B
from ..ops import intersect as I
from ..ops import rng
from ..ops import vec3 as v3
from ..ops.gather import at, host_values
from ..ops.vec3 import V3
from ..scene import types as T
from ..scene.device import RenderConfig
from .camera import generate_rays
from .common import (background_pdf, background_radiance,
                     sample_background, sample_emit_object)

TMIN = 1e-3
TMAX = 1e5
RR_START = 12
FLT_MIN_NORMAL = 1.17549435e-38   # the least normal float32


def max_depth_for(config: RenderConfig) -> int:
    if config.max_depth_hint is not None:
        return max(int(config.max_depth_hint), 1)
    return 50  # reference lib.rs:192


def any_normal(c: V3):
    """Some channel of the throughput is a normal float32 (not zero, not
    subnormal): what `any_nonzero` reads after XLA's flush to zero."""
    return ((torch.abs(c.x) >= FLT_MIN_NORMAL)
            | (torch.abs(c.y) >= FLT_MIN_NORMAL)
            | (torch.abs(c.z) >= FLT_MIN_NORMAL))


def gather3(table, idx) -> V3:
    g = at(table, idx)
    return V3(g[:, 0], g[:, 1], g[:, 2])


def pixel_states(config, px, py, seed):
    """pcg_init(pix ^ seed) of each lane's pixel pix = py * W + px, the
    seed a uint32."""
    w = config.film.xresolution
    pix = (py.long() * w + px.long()) & rng.MASK
    return rng.pcg_init(pix ^ (int(seed) & rng.MASK))


def light_rows(buffers, config, n, device):
    """Each distant light's (direction V3 broadcast over the lanes,
    colour V3 of floats)."""
    dirs = host_values(buffers["light_dir"])
    cols = host_values(buffers["light_color"])
    return [(V3(*(torch.full((n,), c, device=device) for c in dirs[li])),
             V3(*cols[li])) for li in range(config.num_lights)]


def rays_per_lane(config) -> float:
    return (1.0 + config.num_lights
            + (1.0 if config.num_emit_objects > 0 else 0.0))


def render_batch(buffers, config: RenderConfig, px, py, seed, num_samples,
                 accel=None):
    """`num_samples` samples of each pixel (px, py), with path
    regeneration. Returns the summed (not averaged) radiance, normal and
    albedo as (N, 3) tensors, the traced-ray count (a float32 0-d tensor)
    and the loop's `iterations`."""
    n = px.shape[0]
    dev = px.device
    state = pixel_states(config, px, py, seed)
    org, direction, state = generate_rays(buffers, config, px, py, state)

    max_depth = max_depth_for(config)
    num_emit = config.num_emit_objects
    use_rr = max_depth > RR_START + 1
    lights = light_rows(buffers, config, n, dev)
    n_strat = num_emit + (1 if config.env_nee else 0)

    color = V3.ones((n,), dev)
    depth = torch.zeros((n,), dtype=torch.int64, device=dev)
    sample = torch.zeros((n,), dtype=torch.int64, device=dev)
    radiance = V3.zeros((n,), dev)
    aov_normal = V3.zeros((n,), dev)
    aov_albedo = V3.zeros((n,), dev)
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    iterations = 0

    while bool((sample < num_samples).any()):
        iterations += 1
        active = sample < num_samples
        color0 = color
        rays = rays + active.to(torch.float32).sum() * rays_per_lane(config)

        hit = I.trace(buffers, config, org, direction, TMIN, TMAX,
                      accel=accel)

        # a miss: the background (lib.rs:209-211)
        bg = background_radiance(buffers, direction, config)
        miss = active & ~hit["hit"]
        radiance = radiance + v3.where(miss, color * bg, 0.0)
        path_alive = active & hit["hit"]

        wo = -direction.normalized()
        normal = hit["normal"].normalized()
        position = hit["position"]
        uv = hit["uv"]
        inst = hit["inst"]
        mat_idx = at(buffers["inst_material"], inst)
        al_idx = at(buffers["inst_area_light"], inst)

        onb = v3.Onb.from_w(normal)
        lobes = B.compute_bsdf(buffers, mat_idx, uv, config)

        # the emitter hit, one-sided (area_light.rs:66-73)
        al_color = gather3(buffers["area_color"], al_idx)
        al_on = ((at(buffers["area_type"], al_idx) != T.AREA_NULL)
                 & (wo.dot(normal) > 0.0))
        radiance = radiance + v3.where(path_alive & al_on, color * al_color,
                                       0.0)

        # the AOVs at each path's depth 0, summed over samples
        first = path_alive & (depth == 0)
        albedo = B.material_albedo(buffers, mat_idx, uv, config)
        aov_normal = aov_normal + v3.where(first, normal, 0.0)
        aov_albedo = aov_albedo + v3.where(first, albedo, 0.0)

        # NEE toward the distant lights (lib.rs:234-272)
        for wi_l, lc in lights:
            shadowed = I.occluded(buffers, config, position, wi_l, TMIN,
                                  TMAX, accel=accel)
            f_l = B.bsdf_f(lobes, onb, normal, wo, wi_l, config)
            contrib = color * f_l * torch.abs(wi_l.dot(normal)) * lc
            radiance = radiance + v3.where(path_alive & ~shadowed, contrib,
                                           0.0)

        # the scatter: the MIS mixture, or BSDF sampling alone. The light
        # strategies are the emitters and (env_nee) the env map; a
        # light-sampled direction continues the path.
        swi, sf, spdf, state = B.bsdf_sample_f(lobes, onb, wo, state, config)
        if n_strat > 0:
            coin, state = rng.next_f32(state)
            if num_emit > 0:
                ls_wi, state = sample_emit_object(buffers, config,
                                                  position, state)
            if config.env_nee:
                env_wi, _, state = sample_background(buffers, state)
                if num_emit > 0:
                    upick, state = rng.next_f32(state)
                    take_env = upick * n_strat < 1.0
                    ls_wi = v3.where(take_env, env_wi, ls_wi)
                else:
                    ls_wi = env_wi
            take_light = coin > 0.5
            use_mis = B.bsdf_contains(lobes, T.KIND_DIFFUSE)
            sel_l = use_mis & take_light
            wi = v3.where(sel_l, ls_wi, swi)
            f = v3.where(sel_l,
                         B.bsdf_f(lobes, onb, normal, wo, ls_wi, config), sf)
            pdf_b = torch.where(sel_l,
                                B.bsdf_pdf(lobes, onb, wo, ls_wi, config),
                                spdf)
            light_pdf = torch.zeros_like(spdf)
            if num_emit > 0:
                light_pdf = light_pdf + I.trace_emissive_pdf(
                    buffers, config, position, wi, TMIN, TMAX, accel=accel)
            if config.env_nee:
                light_pdf = light_pdf + background_pdf(buffers, wi)
            light_pdf = light_pdf / n_strat
            pdf = torch.where(use_mis, 0.5 * pdf_b + 0.5 * light_pdf, spdf)
            f = v3.where(use_mis, f, sf)
            wi = v3.where(use_mis, wi, swi)
        else:
            wi, f, pdf = swi, sf, spdf

        path_alive = path_alive & (pdf >= 1e-5)
        color = color * f * (torch.abs(normal.dot(wi))
                             / torch.clamp_min(pdf, 1e-20))
        path_alive = path_alive & any_normal(color)

        # Russian roulette (per-lane depth; the probability clamped)
        if use_rr:
            rr, state = rng.next_f32(state)
            p_cont = torch.clamp(color.max_component(), 0.0, 1.0)
            do_rr = depth > RR_START
            path_alive = path_alive & (~do_rr | (rr <= p_cont))
            color = v3.where(do_rr & path_alive,
                             color * (1.0 / torch.clamp_min(p_cont, 1e-20)),
                             color)

        new_depth = depth + 1
        path_alive = path_alive & (new_depth < max_depth)

        # regeneration: a finished lane starts its next sample
        finished = active & ~path_alive
        sample = sample + finished.long()
        regen = finished & (sample < num_samples)
        cam_org, cam_dir, state = generate_rays(buffers, config, px, py,
                                                state)
        org = v3.where(regen, cam_org, v3.where(path_alive, position, org))
        direction = v3.where(regen, cam_dir,
                             v3.where(path_alive, wi, direction))
        color = v3.where(regen, 1.0, v3.where(path_alive, color, color0))
        depth = torch.where(regen, 0, torch.where(path_alive, new_depth,
                                                  depth))

    return {"radiance": radiance.to_array(), "normal": aov_normal.to_array(),
            "albedo": aov_albedo.to_array(), "rays": rays,
            "iterations": iterations}


def render_sample(buffers, config: RenderConfig, px, py, seed, accel=None):
    """One sample of each pixel."""
    return render_batch(buffers, config, px, py, seed, 1, accel=accel)
