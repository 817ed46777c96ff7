"""The port's denoisers (rene_tpu_torch/models) against rene_tpu's: the
weight reader, à-trous, the U-Net, the convergence blend and SSIM."""
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rene_tpu.models import denoise as R
from rene_tpu.utils import ssim as RS
from rene_tpu_torch.models import denoise as D
from rene_tpu_torch.models import msgpack as M
from rene_tpu_torch.utils import ssim as PS

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = sorted((REPO / "rene_tpu" / "models" / "weights").glob("*.msgpack"))
UNET = REPO / "rene_tpu" / "models" / "weights" / "unet.msgpack"
# an odd film: the U-Net's pools floor 45 -> 22 -> 11 -> 5
H, W = 45, 52
ATROUS_TOL = dict(atol=1e-6, rtol=1e-5)
UNET_TOL = dict(atol=1e-5, rtol=1e-4)


def film(seed=0):
    g = np.random.default_rng(seed)
    color = (g.random((H, W, 3)) * 2.0).astype(np.float32)
    color[10:20, 5:30] += 3.0                       # an edge to keep
    normal = g.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal[:, W // 2:] = (0.0, 0.0, 1.0)
    albedo = g.random((H, W, 3)).astype(np.float32)
    return color, normal, albedo


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def ref():
    """One run of each reference network on the film (the flax U-Net
    compiles for each net and shape)."""
    c, n, a = film()
    base = R.atrous_denoise(c, n, a)
    net = R.UNetDenoiser.load(str(UNET))
    # a seeded flax init, its zero head made nonzero so that every layer
    # counts
    seeded = R.UNetDenoiser(features=8, levels=3)
    params = numpy_tree(seeded.init(jax.random.PRNGKey(5), 16, 16))
    g = np.random.default_rng(9)
    params["Conv_0"] = {
        "kernel": (g.standard_normal((3, 3, 8, 3)) * 0.1).astype(np.float32),
        "bias": (g.standard_normal(3) * 0.1).astype(np.float32)}
    seeded.params = params
    return {"film": (c, n, a), "atrous": base, "net": net,
            "unet": np.asarray(net(c, n, a, base=base)),
            "seeded_params": params,
            "seeded": np.asarray(seeded(c, n, a, base=base))}


@pytest.mark.parametrize("path", WEIGHTS, ids=lambda p: p.name)
def test_msgpack_reads_the_reference_weights(path):
    """The same tree, shapes, dtypes and bytes as flax's own reader."""
    import flax.serialization as ser
    blob = path.read_bytes()
    features, levels, tree = M.read_weights(str(path))
    assert (features, levels) == (blob[0], blob[1]) == (16, 3)
    want = ser.msgpack_restore(blob[2:])
    got_l, got_def = jax.tree_util.tree_flatten_with_path(tree)
    want_l, want_def = jax.tree_util.tree_flatten_with_path(want)
    assert got_def == want_def and len(got_l) == 30
    for (pg, g), (pw, w) in zip(got_l, want_l):
        assert pg == pw
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("blob", [b"\xc0", b"\xca\x00\x00\x00\x00",
                                  b"\x81\xa1k\xc3", b"\xd4\x05\x00",
                                  b"\xcf" + bytes(8), b"\xff",
                                  b"\x81\xa1k\xce\x00\x00"])
def test_msgpack_raises_on_what_it_does_not_cover(blob):
    """nil, float, bool, an ext other than an ndarray, uint 64, a negative
    fixint, a truncated uint."""
    with pytest.raises(ValueError):
        M.unpackb(blob)


def test_msgpack_forms():
    """The sized forms of each kind, checked against msgpack itself."""
    msgpack = pytest.importorskip("msgpack")
    obj = {"a" * 40: [1, 200, 70000, 2 ** 31, "x" * 300],
           "m": {str(i): i for i in range(20)},
           "b": b"\x00" * 70000, "l": list(range(20))}
    assert M.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_atrous_matches_reference(ref):
    c, n, a = ref["film"]
    out = D.atrous_denoise(c, n, a, device="cpu")
    assert out.dtype == torch.float32 and out.shape == (H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref["atrous"], **ATROUS_TOL)


def test_unet_matches_reference_weights(ref):
    """The reference's unet.msgpack, read through the port's decoder."""
    c, n, a = ref["film"]
    net = D.UNetDenoiser.load(str(UNET), device="cpu")
    assert (net.features, net.levels) == (16, 3)
    out = net(c, n, a, base=ref["atrous"]).numpy()
    np.testing.assert_allclose(out, ref["unet"], **UNET_TOL)
    # the net does something: its residual is not 0
    assert np.abs(out - ref["atrous"]).max() > 1e-2


def test_unet_matches_seeded_flax_init(ref):
    c, n, a = ref["film"]
    net = D.UNetDenoiser.from_flax(ref["seeded_params"], 8, 3, device="cpu")
    out = net(c, n, a, base=ref["atrous"]).numpy()
    np.testing.assert_allclose(out, ref["seeded"], **UNET_TOL)
    sd = D.params_from_flax(ref["seeded_params"])
    np.testing.assert_array_equal(
        sd["up.2.conv1.weight"][4, 1].numpy(),
        ref["seeded_params"]["Block_6"]["Conv_1"]["kernel"][:, :, 1, 4])


def test_cnn_without_weights_is_atrous(ref):
    c, n, a = ref["film"]
    base = D.atrous_denoise(c, n, a, device="cpu").numpy()
    out = D.denoise(c, n, a, method="cnn", device="cpu")
    np.testing.assert_array_equal(out, base)
    np.testing.assert_array_equal(
        D.UNetDenoiser(device="cpu")(c, n, a).numpy(), base)


def variances(kind, shape, g):
    rel = {"converged": 1e-9, "noisy": 1.0}
    if kind == "inf":
        return np.full(shape, np.inf, np.float32)
    if kind == "mixed":
        v = (g.random(shape) ** 4).astype(np.float32)
        v[: shape[0] // 3] = 1e-9
        return v
    return (g.random(shape) * rel[kind]).astype(np.float32)


@pytest.mark.parametrize("kind", ["converged", "noisy", "mixed", "inf"])
def test_convergence_blend_matches_reference(ref, kind):
    """Equal to the reference's, and no warning where the variance is +inf
    (fault (b): the reference divides inf by inf)."""
    c, _, _ = ref["film"]
    v = variances(kind, c.shape, np.random.default_rng(3))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = R.convergence_blend(c, ref["atrous"], v)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = D.convergence_blend(c, ref["atrous"], v)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if kind == "inf":
        np.testing.assert_array_equal(got, ref["atrous"])
    if kind == "converged":
        np.testing.assert_allclose(got, c, rtol=1e-3)


def test_denoise_matches_reference(ref):
    c, n, a = ref["film"]
    v = variances("mixed", c.shape, np.random.default_rng(4))
    assert D.denoise(c, n, a, method="none", device="cpu") is c
    assert R.denoise(c, n, a, method="none") is c
    np.testing.assert_allclose(
        D.denoise(c, n, a, method="atrous", varmean=v, device="cpu"),
        R.denoise(c, n, a, method="atrous", varmean=v), **ATROUS_TOL)
    net = D.UNetDenoiser.load(str(UNET), device="cpu")
    np.testing.assert_allclose(
        D.denoise(c, n, a, method="cnn", unet=net, device="cpu"),
        R.denoise(c, n, a, method="cnn", unet=ref["net"]), **UNET_TOL)
    with pytest.raises(ValueError):
        D.denoise(c, n, a, method="oidn", device="cpu")


def test_ssim_matches_reference(ref):
    c, n, _ = ref["film"]
    a, b = np.clip(c / 5, 0, 1), np.clip(ref["atrous"] / 5, 0, 1)
    assert PS.ssim(a, b) == RS.ssim(a, b)
    assert PS.ssim(a[..., 0], b[..., 0]) == RS.ssim(a[..., 0], b[..., 0])
    assert PS.ssim(a, a) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        PS.ssim(a, b[:-1])


def test_port_imports_no_flax_or_msgpack():
    """The card has neither: the port reads the weights with its own
    decoder."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(flax|msgpack|jax)\b", re.M)
    files = sorted((REPO / "rene_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert any(f.name == "msgpack.py" for f in files)
    for f in files:
        assert not pat.search(f.read_text()), f
