"""The port's denoiser trainer (rene_tpu_torch/models/train_denoiser.py)
and the U-Net's save / init / train_step against rene_tpu's, on the CPU.

* `synthetic_pairs` draws the reference's arrays: noisy, normal, albedo
  and clean bit for bit, the à-trous base within the denoiser tests'
  à-trous tolerance (atol 1e-6, rtol 1e-5).
* An untrained port net gives the à-trous base, as the reference's
  `test_untrained_net_equals_atrous` holds for its own.
* From the reference's `init(PRNGKey(seed))` carried across by
  `params_from_flax` (the `net` of the port's `train`), on the same
  batches: the loss of step 0 within 1e-5 relative of JAX's
  `value_and_grad`, each leaf's gradient within 1e-4 of its largest |g|
  (also from a nonzero head, where every leaf's gradient is nonzero),
  and the losses of the first three Adam steps within 1e-4 relative of
  the reference's `train`.
* `UNetDenoiser.train_step`, one plain L1 step under SGD and Adam
  against the reference's `train_step` under optax's: the loss within
  1e-5 relative, each leaf after the step within 1e-4 of its largest
  change.
* A port-written weight file loads in `rene_tpu.models.denoise.
  UNetDenoiser.load` (its output within the U-Net tolerance of the
  port's, atol 1e-5, rtol 1e-4); the port reads its own file back bit for
  bit, and its bytes are flax's `to_bytes` of the same tree.
* `render_pairs` on an inline scene gives the reference's patch count and
  shapes, its crops slices of the films; the trainer's command line
  writes weights that the port's CLI reads with `--denoiser cnn`.
* `slow`, as in the reference: the loss falls below 0.75x over 200 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rene_tpu.models import denoise as RD
from rene_tpu.models import train_denoiser as RT
from rene_tpu_torch import cli, scenes
from rene_tpu_torch.models import denoise as D
from rene_tpu_torch.models import msgpack as M
from rene_tpu_torch.models import train_denoiser as T

torch.set_num_threads(2)

SIZE = 32           # patch edge of these tests (the trainer's PATCH is 64)
ATROUS_TOL = dict(atol=1e-6, rtol=1e-5)
UNET_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def pairs():
    return (RT.synthetic_pairs(6, seed=5, size=SIZE),
            T.synthetic_pairs(6, seed=5, size=SIZE, device="cpu"))


def test_synthetic_pairs_match_reference(pairs):
    ref, got = pairs
    for i, name in enumerate(("noisy", "normal", "albedo", "clean")):
        assert got[i].dtype == np.float32 and got[i].shape == (6, SIZE,
                                                               SIZE, 3)
        assert np.array_equal(got[i], ref[i]), name
    assert (got[0] > got[3] + 1.0).any()      # the fireflies
    np.testing.assert_allclose(got[4], ref[4], **ATROUS_TOL)


def test_untrained_net_equals_atrous(pairs):
    _, (noisy, normal, albedo, _, _) = pairs
    net = D.UNetDenoiser(features=8, device="cpu").init(0)
    out = net(noisy[0], normal[0], albedo[0]).numpy()
    base = D.atrous_denoise(noisy[0], normal[0], albedo[0], device="cpu")
    np.testing.assert_array_equal(out, base.numpy())
    np.testing.assert_allclose(
        out, RD.atrous_denoise(noisy[0], normal[0], albedo[0]), atol=1e-6)
    # every convolution but the head drew weights: the head alone is 0
    convs = [m for m in net.net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert all(m.weight.abs().max() > 0 for m in convs[:-1])
    assert not net.net.head.weight.any()
    again = D.UNetDenoiser(features=8, device="cpu").init(0)
    assert all(torch.equal(a, b) for a, b in zip(
        net.net.state_dict().values(), again.net.state_dict().values()))


def _ref_loss(net, p, batch):
    """The reference trainer's loss_fn (rene_tpu/models/train_denoiser.py
    :129-131) on one batch."""
    noisy, normal, albedo, clean, base = batch
    x = jnp.concatenate([noisy, base, normal, albedo], axis=-1)
    pred = base + net.module.apply({"params": p}, x)

    def tm(v):
        return (jnp.maximum(v, 0.0) + 1e-3) ** (1.0 / 2.2)
    return jnp.mean(jnp.abs(tm(pred) - tm(clean)))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("head", ["zero", "drawn"])
def test_loss_and_gradients_match_reference(pairs, head):
    ref_data, _ = pairs
    seed, batch = 4, 4
    r_net = RD.UNetDenoiser(features=8)
    params = r_net.init(jax.random.PRNGKey(seed), T.PATCH, T.PATCH)
    params = jax.tree_util.tree_map(np.asarray, params)
    if head == "drawn":     # every leaf's gradient nonzero
        k = params["Conv_0"]["kernel"]
        params["Conv_0"]["kernel"] = (np.random.default_rng(1).standard_normal(
            k.shape) * 0.05).astype(np.float32)
    idx = np.random.default_rng(seed).integers(0, 6, size=batch)
    loss_r, grads_r = jax.jit(jax.value_and_grad(
        lambda p, b: _ref_loss(r_net, p, b)))(
            params, [jnp.asarray(a[idx]) for a in ref_data])
    net = D.UNetDenoiser.from_flax(params, 8, 3, device="cpu")
    data = tuple(torch.from_numpy(a) for a in ref_data)
    loss = T.batch_loss(net, data, torch.from_numpy(idx))
    loss.backward()
    print(f"head {head}: loss {loss.item():.8f} / {float(loss_r):.8f}")
    assert abs(loss.item() - float(loss_r)) <= 1e-5 * float(loss_r)
    grads = D.params_to_flax({n: p.grad for n, p in
                              net.net.named_parameters()}, 3)
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, grads_r)))
    got = dict(_leaves(grads))
    assert got.keys() == want.keys()
    nonzero = 0
    for name, g in got.items():
        scale = np.abs(want[name]).max()
        assert np.abs(g - want[name]).max() <= 1e-4 * scale, name
        nonzero += bool(scale > 0)
    assert nonzero == (2 if head == "zero" else len(got))


def test_adam_steps_match_reference_train(pairs):
    ref_data, _ = pairs
    seed = 2
    _, losses_r = RT.train(ref_data, steps=3, batch=4, features=8,
                           seed=seed, log_every=0)
    params = RD.UNetDenoiser(features=8).init(jax.random.PRNGKey(seed),
                                              T.PATCH, T.PATCH)
    net = D.UNetDenoiser.from_flax(
        jax.tree_util.tree_map(np.asarray, params), 8, 3, device="cpu")
    _, losses = T.train(ref_data, steps=3, batch=4, seed=seed, log_every=0,
                        device="cpu", net=net)
    print(f"losses {losses} / {losses_r}")
    assert abs(losses[0] - losses_r[0]) <= 1e-5 * losses_r[0]
    np.testing.assert_allclose(losses, losses_r, rtol=1e-4)
    assert losses[2] != losses[0]


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_train_step_matches_reference(pairs, opt):
    """One `train_step` (the plain L1 step) of each net from the
    reference's `init` on the same batch, with optax's and torch's
    optimizer of the same rate: the loss within 1e-5 relative, and each
    leaf after the step within 1e-4 of that leaf's largest change."""
    import optax
    ref_data, _ = pairs
    lr = 1e-3
    r_net = RD.UNetDenoiser(features=8)
    params = jax.tree_util.tree_map(np.asarray, r_net.init(
        jax.random.PRNGKey(3), T.PATCH, T.PATCH))
    batch = [a[:4] for a in ref_data]
    tx = {"sgd": optax.sgd, "adam": optax.adam}[opt](lr)
    step_r = jax.jit(r_net.train_step, static_argnums=2)
    new_r, _, loss_r = step_r(params, tx.init(params), tx,
                              *(jnp.asarray(a) for a in batch))
    net = D.UNetDenoiser.from_flax(params, 8, 3, device="cpu")
    optimizer = {"sgd": torch.optim.SGD, "adam": torch.optim.Adam}[opt](
        net.net.parameters(), lr=lr)
    loss = net.train_step(optimizer, *batch)
    print(f"{opt}: loss {loss:.8f} / {float(loss_r):.8f}")
    assert abs(loss - float(loss_r)) <= 1e-5 * float(loss_r)
    before = dict(_leaves(params))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, new_r)))
    got = dict(_leaves(D.params_to_flax(net.net.state_dict(), 3)))
    assert got.keys() == want.keys()
    moved = 0
    for name, p in got.items():
        step = np.abs(want[name] - before[name]).max()
        assert np.abs(p - want[name]).max() <= 1e-4 * step, name
        moved += bool(step > 0)
    assert moved == 2       # the zero head's kernel and bias


def test_weight_file_loads_in_reference(tmp_path, pairs):
    _, (noisy, normal, albedo, _, _) = pairs
    net = D.UNetDenoiser(features=4, levels=3, device="cpu").init(3)
    with torch.no_grad():       # a head that moves the output
        g = torch.Generator().manual_seed(9)
        net.net.head.weight.copy_(
            torch.randn(net.net.head.weight.shape, generator=g) * 0.05)
    path = str(tmp_path / "w" / "unet.msgpack")
    net.save(path)
    ref = RD.UNetDenoiser.load(path)
    assert (ref.features, ref.levels) == (4, 3)
    out = net(noisy[1], normal[1], albedo[1]).numpy()
    base = D.atrous_denoise(noisy[1], normal[1], albedo[1],
                            device="cpu").numpy()
    assert np.abs(out - base).max() > 1e-3
    np.testing.assert_allclose(ref(noisy[1], normal[1], albedo[1],
                                   base=base), out, **UNET_TOL)
    back = D.UNetDenoiser.load(path, device="cpu")
    for k, v in net.net.state_dict().items():
        assert torch.equal(back.net.state_dict()[k], v), k
    import flax.serialization as ser
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[2:] == ser.to_bytes(ref.params)
    assert M.unpackb(M.packb(M.unpackb(blob[2:]))) is not None


def test_render_pairs_patches(tmp_path, monkeypatch):
    """The reference's patch count and shapes at res 96 (four crop places,
    three flips, two noise levels), the port's crops slices of its
    films."""
    p = tmp_path / "box.pbrt"
    p.write_text(scenes.cornell_box(16, 16))
    from rene_tpu import render as RR
    from rene_tpu_torch import render as PR

    def fake(scene, spp, seed=0, **kw):
        w, h = scene.film.xresolution, scene.film.yresolution
        return {k: np.full((h, w, 3), 0.5, np.float32)
                for k in ("color", "normal", "albedo")}
    monkeypatch.setattr(RR, "render", fake)
    ref = RT.render_pairs(str(p), (1, 2), 4, res=96)
    films = []
    real = PR.render

    def spy(scene, **kw):
        out = real(scene, **kw)
        films.append((kw, out))
        return out
    monkeypatch.setattr(PR, "render", spy)
    got = T.render_pairs(str(p), (1, 2), 4, res=96, device="cpu")
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (24, 64, 64, 3)
        assert g.dtype == np.float32
    assert [(kw["spp"], kw["seed"]) for kw, _ in films] == [
        (4, 202), (1, 101), (2, 138)]
    clean, noisy1 = films[0][1]["color"], films[1][1]["color"]
    assert noisy1.shape == (96, 96, 3)
    assert np.array_equal(got[0][0], noisy1[:64, :64])
    assert np.array_equal(got[0][1], noisy1[:64, :64][::-1])
    assert np.array_equal(got[0][2], noisy1[:64, :64][:, ::-1])
    assert np.array_equal(got[3][3], clean[:64, 32:96])
    assert np.array_equal(got[1][12], films[2][1]["normal"][:64, :64])


def test_cli_trains_weights_the_render_cli_reads(tmp_path, capsys):
    w = str(tmp_path / "w.msgpack")
    T.main(["--out", w, "--steps", "2", "--synthetic", "4", "--features",
            "4", "--device", "cpu"])
    assert "saved" in capsys.readouterr().out
    box = tmp_path / "box.pbrt"
    box.write_text(scenes.cornell_box(12, 8))
    png = tmp_path / "d.png"
    assert cli.main([str(box), "--device", "cpu", "--spp", "2",
                     "--denoiser", "cnn", "--unet-weights", w, "--output",
                     str(png)]) == 0
    assert png.exists()
    assert RD.UNetDenoiser.load(w).features == 4


@pytest.mark.slow
def test_train_reduces_loss_and_beats_identity(tmp_path):
    data = T.synthetic_pairs(24, seed=3, device="cpu")
    net, losses = T.train(data, steps=200, batch=8, features=8, seed=1,
                          lr=2e-3, log_every=0, device="cpu")
    assert np.mean(losses[-10:]) < 0.75 * np.mean(losses[:10])
    noisy, normal, albedo, clean, _ = T.synthetic_pairs(2, seed=99,
                                                        device="cpu")
    out = net(noisy[0], normal[0], albedo[0]).numpy()
    assert np.mean((out - clean[0]) ** 2) < np.mean((noisy[0]
                                                      - clean[0]) ** 2)
    path = str(tmp_path / "w.msgpack")
    net.save(path)
    out2 = D.UNetDenoiser.load(path, device="cpu")(
        noisy[0], normal[0], albedo[0]).numpy()
    np.testing.assert_array_equal(out, out2)
