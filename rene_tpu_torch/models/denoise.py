"""AOV-guided denoisers of the port: à-trous, the U-Net, the blend.

Counterpart of rene_tpu/models/denoise.py. JAX computes all of it outside
any Pallas kernel, and so does this module:

* `atrous_denoise` (:25-75): edge-avoiding à-trous wavelet filtering
  guided by the normal and albedo AOVs, in torch on the caller's device:
  the taps wrap at the film's edges (torch.roll, as jnp.roll there), dy
  outer and dx inner, float32 weights `ky * kx * exp(-dc sc - dn sn - da
  sa)` over max(wsum, 1e-8).
* `UNet` (:144-171): the small U-Net over (noisy, à-trous base, normal,
  albedo) that predicts a residual over the base, NCHW with `F.conv2d`
  for the reference's `Conv3` (its nine shifted einsums are a TPU
  workaround, :87-92), average pooling that floors odd sizes, a nearest
  upsample cropped and then edge-padded to the skip's size, SiLU, and a
  zero-initialised head: without trained weights the net gives the base.
* `UNetDenoiser`: the net with its weights, read from and written to
  the reference's own files (`models/msgpack.py`, `params_from_flax` and
  its inverse `params_to_flax`); `init(seed)` draws the reference's
  initialisation (LeCun normal, truncated at two deviations, zero
  biases, a zero head) from an explicit torch.Generator, and
  `train_step` is the reference's plain L1 step (:220). On the card its
  convolutions run in full float32 (cuDNN would take TF32 by default).
  The trainer is models/train_denoiser.py.
* `denoise` (:239) and `convergence_blend` (:260), the blend in numpy
  float32 as in the reference, with w = 1 where the variance is +inf (a
  one-chunk render) without computing inf / inf.

Every function runs on the device its caller names and raises there; none
falls back to the CPU.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .msgpack import read_weights, write_weights

_TAPS = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)
_OFFSETS = (-2, -1, 0, 1, 2)
IN_CH = 12      # noisy color, its à-trous base, normal, albedo


def _tensor(x, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):     # a copy: films come flipped
        x = np.array(x, np.float32)
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def atrous_denoise(color, normal, albedo, iterations: int = 5,
                   sigma_color: float = 4.0, sigma_normal: float = 128.0,
                   sigma_albedo: float = 8.0, device="cuda") -> torch.Tensor:
    """Edge-avoiding à-trous wavelet denoise of (H, W, 3) images on
    `device`; returns the (H, W, 3) float32 tensor there."""
    c, n, a = (_tensor(x, device) for x in (color, normal, albedo))
    taps = torch.tensor(_TAPS, dtype=torch.float32)
    for i in range(iterations):
        step = 1 << i
        acc = torch.zeros_like(c)
        wsum = torch.zeros(c.shape[:2] + (1,), dtype=torch.float32,
                           device=c.device)
        for dy, ky in zip(_OFFSETS, taps):
            for dx, kx in zip(_OFFSETS, taps):
                shift = (-dy * step, -dx * step)
                cc = torch.roll(c, shift, (0, 1))
                nn_ = torch.roll(n, shift, (0, 1))
                aa = torch.roll(a, shift, (0, 1))
                dc = ((c - cc) ** 2).sum(-1, keepdim=True)
                dn = ((n - nn_) ** 2).sum(-1, keepdim=True)
                da = ((a - aa) ** 2).sum(-1, keepdim=True)
                wgt = float(ky * kx) * torch.exp(
                    -dc * sigma_color - dn * sigma_normal - da * sigma_albedo)
                acc = acc + wgt * cc
                wsum = wsum + wgt
        c = acc / torch.clamp(wsum, min=1e-8)
    return c


class Block(nn.Module):
    """Two 3x3 convolutions, each followed by SiLU (:133-142)."""

    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, ch, 3, padding=1)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return F.silu(self.conv1(F.silu(self.conv0(x))))


class UNet(nn.Module):
    """The reference's UNet (:144-171) in NCHW: `levels` blocks down
    (features << l channels, each followed by a 2x2 average pool), a
    bottleneck, `levels` blocks up over [upsampled, skip], and a 3x3 head
    to 3 channels, zero at initialisation."""

    def __init__(self, features: int = 24, levels: int = 3):
        super().__init__()
        self.down = nn.ModuleList(
            Block(IN_CH if l == 0 else features << (l - 1), features << l)
            for l in range(levels))
        self.mid = Block(features << (levels - 1), features << levels)
        self.up = nn.ModuleList(
            Block((features << (l + 1)) + (features << l), features << l)
            for l in reversed(range(levels)))
        self.head = nn.Conv2d(features, 3, 3, padding=1)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def forward(self, x):
        skips = []
        h = x
        for block in self.down:
            h = block(h)
            skips.append(h)
            h = F.avg_pool2d(h, 2)
        h = self.mid(h)
        for block, skip in zip(self.up, reversed(skips)):
            sh, sw = skip.shape[2:]
            h = h.repeat_interleave(2, 2).repeat_interleave(2, 3)[:, :, :sh,
                                                                  :sw]
            # odd skip sizes: the pool floored (45 -> 22), so the upsample
            # comes back one short; edge-pad it up
            h = F.pad(h, (0, sw - h.shape[3], 0, sh - h.shape[2]),
                      mode="replicate")
            h = block(torch.cat([h, skip], 1))
        return self.head(h)


def params_from_flax(tree) -> dict:
    """The state dict of `UNet` from the reference's parameter tree
    (numpy leaves): Block_0 .. Block_{L-1} down, Block_L the bottleneck,
    Block_{L+1} .. Block_{2L} up, Conv_0 the head; each kernel HWIO ->
    OIHW."""
    blocks = sorted((k for k in tree if k.startswith("Block_")),
                    key=lambda k: int(k.split("_")[1]))
    levels = (len(blocks) - 1) // 2
    names = ([f"down.{i}" for i in range(levels)] + ["mid"]
             + [f"up.{i}" for i in range(levels)])
    sd = {}

    def conv(prefix, p):
        sd[prefix + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["kernel"], np.float32)
                                 .transpose(3, 2, 0, 1)))
        sd[prefix + ".bias"] = torch.from_numpy(
            np.asarray(p["bias"], np.float32).copy())

    for name, key in zip(names, blocks):
        conv(name + ".conv0", tree[key]["Conv_0"])
        conv(name + ".conv1", tree[key]["Conv_1"])
    conv("head", tree["Conv_0"])
    return sd


def params_to_flax(state_dict, levels: int) -> dict:
    """The reference's parameter tree (numpy float32 leaves, in flax's
    order) from a state dict of `UNet` with `levels` levels, or from any
    dict of tensors under its names (gradients, say): the inverse of
    `params_from_flax`, each kernel OIHW -> HWIO."""
    names = ([f"down.{i}" for i in range(levels)] + ["mid"]
             + [f"up.{i}" for i in range(levels)])

    def conv(prefix):
        w = state_dict[prefix + ".weight"].detach().cpu().numpy()
        return {"kernel": np.ascontiguousarray(
                    w.astype(np.float32).transpose(2, 3, 1, 0)),
                "bias": state_dict[prefix + ".bias"].detach().cpu().numpy()
                .astype(np.float32)}

    tree = {f"Block_{i}": {"Conv_0": conv(name + ".conv0"),
                           "Conv_1": conv(name + ".conv1")}
            for i, name in enumerate(names)}
    tree["Conv_0"] = conv("head")
    return tree


# flax's lecun_normal: a normal truncated at two deviations, rescaled to
# unit variance (flax/linen/initializers.py variance_scaling)
_TRUNC_STD = 0.87962566103423978


@contextlib.contextmanager
def _full_float32():
    """cuDNN's convolutions in float32 inside (its default is TF32), the
    previous setting after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


class UNetDenoiser:
    """The U-Net on `device` with its weights: base + residual, where the
    base is the à-trous output. Without weights (torch's initialisation,
    a zero head) it gives the base exactly."""

    def __init__(self, features: int = 24, levels: int = 3,
                 device="cuda"):
        self.features, self.levels = features, levels
        self.device = torch.device(device)
        # torch's own initialisation of the blocks, without moving its
        # global random state; the head is zero whatever they hold
        with torch.random.fork_rng(devices=[]):
            self.net = UNet(features, levels).to(self.device).eval()

    @classmethod
    def from_flax(cls, tree, features: int, levels: int,
                  device="cuda") -> "UNetDenoiser":
        den = cls(features, levels, device)
        den.net.load_state_dict(params_from_flax(tree))
        return den

    def init(self, seed: int = 0) -> "UNetDenoiser":
        """Fresh weights drawn as the reference's `init` draws them (:198):
        each convolution's kernel LeCun normal over its 9 x cin inputs,
        truncated at two deviations, from a torch.Generator seeded with
        `seed` (not JAX's draws: the same distribution, other numbers),
        its bias zero, and the head zero, so that the net gives the
        à-trous base."""
        g = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for m in self.net.modules():
                if not isinstance(m, nn.Conv2d):
                    continue
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                if m is self.net.head:
                    w.zero_()
                else:
                    std = (1.0 / (9 * m.in_channels)) ** 0.5 / _TRUNC_STD
                    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std,
                                          2.0 * std, generator=g)
                m.weight.copy_(w)
                m.bias.zero_()
        return self

    def save(self, path: str) -> None:
        """The reference's weight file (:177): the header bytes (features,
        levels), then the flax msgpack of the parameter tree, which
        `rene_tpu.models.denoise.UNetDenoiser.load` and `load` read."""
        write_weights(path, self.features, self.levels,
                      params_to_flax(self.net.state_dict(), self.levels))

    def train_step(self, optimizer, noisy, normal, albedo, clean,
                   base) -> float:
        """One step of `optimizer` (over `self.net.parameters()`) on the
        reference's plain L1 loss (:220), mean |base + residual - clean|
        over (B, H, W, 3) batches; returns the loss."""
        noisy, normal, albedo, clean, base = (
            _tensor(a, self.device)
            for a in (noisy, normal, albedo, clean, base))
        x = torch.cat([noisy, base, normal, albedo], -1).permute(0, 3, 1, 2)
        self.net.train()
        with _full_float32():
            pred = base + self.net(x.contiguous()).permute(0, 2, 3, 1)
            loss = (pred - clean).abs().mean()
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
        self.net.eval()
        return loss.item()

    @classmethod
    def load(cls, path: str, device="cuda") -> "UNetDenoiser":
        """The weights of `rene_tpu.models.denoise.UNetDenoiser.save`
        (two header bytes, flax msgpack), read in place."""
        features, levels, tree = read_weights(path)
        return cls.from_flax(tree, features, levels, device)

    def __call__(self, color, normal, albedo, base=None) -> torch.Tensor:
        """Denoise one (H, W, 3) film; `base` is the à-trous output
        (computed here when not given). Returns an (H, W, 3) float32
        tensor on the denoiser's device."""
        c, n, a = (_tensor(x, self.device) for x in (color, normal, albedo))
        if base is None:
            base = atrous_denoise(c, n, a, device=self.device)
        base = _tensor(base, self.device)
        x = torch.cat([c, base, n, a], -1).permute(2, 0, 1)[None]
        with torch.no_grad(), _full_float32():
            residual = self.net(x.contiguous())[0].permute(1, 2, 0)
        return base + residual


def denoise(color, normal, albedo, method: str = "atrous",
            unet: Optional[UNetDenoiser] = None, varmean=None,
            device="cuda") -> np.ndarray:
    """The denoised color on the host, float32 (H, W, 3): à-trous or the
    U-Net (an untrained one where `unet` is None) on `device`; with
    `varmean` (the render's `want_var`), the convergence blend of it with
    the raw color, so that a converged render passes through."""
    if method in ("none", None):
        return color
    if method == "atrous":
        den = atrous_denoise(color, normal, albedo, device=device)
    elif method == "cnn":
        den = (unet or UNetDenoiser(device=device))(color, normal, albedo)
    else:
        raise ValueError(f"unknown denoiser {method}")
    den = den.cpu().numpy()
    if varmean is None:
        return den
    return convergence_blend(color, den, varmean)


_LUMA = (0.299, 0.587, 0.114)


def convergence_blend(raw, den, varmean, knee: float = 0.03) -> np.ndarray:
    """Per-pixel Wiener-style shrink of the denoised image toward the raw
    one (:260-281): w = v / (v + (knee * signal)^2), v the variance of
    the raw mean and signal the local luma, box-smoothed twice (3x3,
    edge-replicated). Where v is +inf (one chunk), w is 1, set directly."""
    raw = np.asarray(raw, np.float32)
    den = np.asarray(den, np.float32)
    lum = np.asarray(varmean, np.float32) @ np.float32(_LUMA)
    sig = raw @ np.float32(_LUMA)
    floor = np.float32(max(np.mean(sig) * 0.05, 1e-6))
    d2 = (knee * np.maximum(sig, floor)) ** 2
    finite = np.isfinite(lum)
    v = np.where(finite, lum, np.float32(0))
    w = np.where(finite, v / (v + d2), np.float32(1))
    for _ in range(2):
        p = np.pad(w, 1, mode="edge")
        w = sum(p[1 + dy:p.shape[0] - 1 + dy, 1 + dx:p.shape[1] - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)) / 9.0
    return raw + w[..., None] * (den - raw)
