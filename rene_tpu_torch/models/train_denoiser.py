"""Training of the U-Net denoiser on the port's own renders.

Counterpart of rene_tpu/models/train_denoiser.py. The reference trains
with optax and XLA (the U-Net's `Conv3` is nine einsums outside any
Pallas kernel, rene_tpu/models/denoise.py:106,126); here the net is
models/denoise.py's `UNet` (`F.conv2d`), its gradients come from
autograd and its steps from torch.optim.Adam.

* `synthetic_pairs` (:27): piecewise-constant patches with luminance-
  scaled noise and sparse fireflies, numpy draw for draw the reference's;
  the à-trous base by the port's `atrous_denoise`.
* `render_pairs` (:68): (noisy, clean) renders of a pbrt scene at a
  square resolution (`FlatScene.set_film_resolution`) through the port's
  `render` on the caller's device (`auto`: the megakernel, or the XLA
  engine for a scene the kernels refuse), cut into PATCH crops with flip
  augmentation; the base is computed on the whole film first.
* `train` (:101): Adam at the reference's rate on the L1 loss between
  the tonemapped prediction (base + residual) and the tonemapped clean
  patch, tonemap(x) = (max(x, 0) + 1e-3) ** (1 / 2.2) (:121); batches
  of `np.random.default_rng(seed).integers(0, n, size=batch)` (:145),
  so a run draws the reference's batches. Its start is `init(seed)` (the
  reference's distribution from a torch.Generator), or the `net` given,
  e.g. one carried over from the reference's own parameters. On the card
  cuDNN's TF32 is off, as for inference.

Usage:
    python -m rene_tpu_torch.models.train_denoiser --scene a.pbrt \\
        --out weights/unet.msgpack --steps 800 [--device cuda|cpu]

The weights are the reference's file (`UNetDenoiser.save`), which
`python -m rene_tpu_torch.cli --denoiser cnn --unet-weights W` and
rene_tpu's CLI both read.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .denoise import UNetDenoiser, _full_float32, atrous_denoise

PATCH = 64


def synthetic_pairs(n: int, seed: int = 0, size: int = PATCH,
                    device="cuda"):
    """Procedural (noisy, normal, albedo, clean, base) batches of (n, size,
    size, 3) float32: random soft-edged constant regions as 'clean',
    Monte-Carlo-like noise scaled by luminance, sparse fireflies; the
    à-trous base computed on `device`."""
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    clean = np.zeros((n, size, size, 3), np.float32)
    normal = np.zeros_like(clean)
    albedo = np.zeros_like(clean)
    for i in range(n):
        img = np.zeros((size, size, 3), np.float32)
        nrm = np.zeros((size, size, 3), np.float32)
        alb = np.zeros((size, size, 3), np.float32)
        for _ in range(4):
            cx, cy, rad = r.uniform(0, 1, 3)
            mask = ((xx - cx) ** 2 + (yy - cy) ** 2
                    < (0.15 + 0.3 * rad) ** 2)
            col = r.uniform(0, 1.5, 3).astype(np.float32)
            nv = r.normal(size=3).astype(np.float32)
            nv /= max(np.linalg.norm(nv), 1e-6)
            img[mask] = col
            nrm[mask] = nv
            alb[mask] = col / max(col.max(), 1e-6)
        clean[i], normal[i], albedo[i] = img, nrm, alb
    lum = clean.mean(-1, keepdims=True)
    noisy = np.maximum(
        clean + r.normal(size=clean.shape).astype(np.float32)
        * (0.08 + 0.25 * np.sqrt(np.maximum(lum, 0.0))), 0.0
    ).astype(np.float32)
    # sparse fireflies (low-spp outliers), which the net must learn to
    # suppress as the à-trous edge-stopping does
    spark = r.random(noisy.shape[:3]) < 0.002
    noisy[spark] += r.gamma(1.5, 4.0, size=(spark.sum(), 1)).astype(
        np.float32) * r.uniform(0.5, 1.0, (spark.sum(), 3)).astype(
        np.float32)
    base = np.stack([atrous_denoise(noisy[i], normal[i], albedo[i],
                                    device=device).cpu().numpy()
                     for i in range(n)]).astype(np.float32)
    return noisy, normal, albedo, clean, base


def render_pairs(scene_path: str, noisy_spps=(4, 32), clean_spp: int = 512,
                 res: int = 256, color_space: str = "srgb-lights",
                 augment: bool = True, device="cuda", engine: str = "auto"):
    """Render a scene at each of `noisy_spps` against one clean render,
    all at res x res on `device`, and cut the films into PATCH crops
    (each also flipped in y and in x with `augment`); returns the five
    arrays (noisy, normal, albedo, clean, base) of (n, PATCH, PATCH, 3)
    float32, the base the à-trous output of the whole noisy film."""
    from ..render import render
    from ..scene import load_scene

    scene = load_scene(scene_path, color_space=color_space)
    scene.set_film_resolution(res, res)
    clean = render(scene, spp=clean_spp, seed=202, device=device,
                   engine=engine)

    crops = []
    for k, spp in enumerate(noisy_spps):
        noisy = render(scene, spp=spp, seed=101 + 37 * k, device=device,
                       engine=engine)
        base = atrous_denoise(noisy["color"], noisy["normal"],
                              noisy["albedo"], device=device).cpu().numpy()
        films = (noisy["color"], noisy["normal"], noisy["albedo"],
                 clean["color"], base)
        for y in range(0, res - PATCH + 1, PATCH // 2):
            for x in range(0, res - PATCH + 1, PATCH // 2):
                sl = (slice(y, y + PATCH), slice(x, x + PATCH))
                crop = [f[sl] for f in films]
                crops.append(crop)
                if augment:
                    crops.append([c[::-1] for c in crop])
                    crops.append([c[:, ::-1] for c in crop])
    return tuple(np.stack([c[i] for c in crops]).astype(np.float32)
                 for i in range(5))


def tonemap(x: torch.Tensor) -> torch.Tensor:
    """Display space, where SSIM scores the images (:121); the epsilon
    keeps the gamma's gradient finite at 0."""
    return (torch.clamp_min(x, 0.0) + 1e-3) ** (1.0 / 2.2)


def batch_loss(net: UNetDenoiser, data, idx: torch.Tensor) -> torch.Tensor:
    """The training loss of batch `idx` of `data` (the five arrays as
    tensors on the net's device): mean |tonemap(base + residual) -
    tonemap(clean)|."""
    noisy, normal, albedo, clean, base = (a[idx] for a in data)
    x = torch.cat([noisy, base, normal, albedo], -1).permute(0, 3, 1, 2)
    pred = base + net.net(x.contiguous()).permute(0, 2, 3, 1)
    return (tonemap(pred) - tonemap(clean)).abs().mean()


def train(data, steps: int = 400, batch: int = 8, lr: float = 1e-3,
          features: int = 16, seed: int = 0, log_every: int = 50,
          progress=print, device="cuda", net: UNetDenoiser = None):
    """Train a UNetDenoiser on the (noisy, normal, albedo, clean, base)
    arrays on `device`, from `net` if given, else from
    `UNetDenoiser(features).init(seed)`; returns the trained denoiser and
    the loss of every step."""
    device = torch.device(device)
    if net is None:
        net = UNetDenoiser(features=features, device=device).init(seed)
    data = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in data)
    optimizer = torch.optim.Adam(net.net.parameters(), lr=lr)
    r = np.random.default_rng(seed)
    n = int(data[0].shape[0])
    losses = []
    t0 = time.time()
    net.net.train()
    with _full_float32():
        for s in range(steps):
            idx = torch.from_numpy(r.integers(0, n, size=batch)).to(device)
            loss = batch_loss(net, data, idx)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
            if log_every and (s + 1) % log_every == 0:
                progress(f"step {s + 1}/{steps} loss={losses[-1]:.4f} "
                         f"({time.time() - t0:.1f}s)")
    net.net.eval()
    return net, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", action="append", default=[],
                    help="pbrt scene(s) for render pairs (repeatable; "
                    "omit for synthetic data)")
    ap.add_argument("--out", required=True, help="weights output path")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--features", type=int, default=16)
    ap.add_argument("--noisy-spp", type=int, action="append", default=[],
                    help="noise levels to render per scene (repeatable; "
                    "default 4 and 32)")
    ap.add_argument("--clean-spp", type=int, default=512)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="also mix in N synthetic patches")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: render and train on the card (default); "
                         "cpu: the plain versions and the CPU")
    args = ap.parse_args(argv)

    spps = tuple(args.noisy_spp) or (4, 32)
    parts = []
    for sc in args.scene:
        parts.append(render_pairs(sc, spps, args.clean_spp,
                                  device=args.device))
        print(f"{sc}: {parts[-1][0].shape[0]} patches", flush=True)
    if args.synthetic or not args.scene:
        parts.append(synthetic_pairs(args.synthetic or 64,
                                     device=args.device))
    data = tuple(np.concatenate([p[i] for p in parts]) for i in range(5))
    print(f"training on {data[0].shape[0]} patches")
    net, losses = train(data, steps=args.steps, batch=args.batch,
                        features=args.features, lr=args.lr,
                        device=args.device)
    net.save(args.out)
    print(f"saved {args.out}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
