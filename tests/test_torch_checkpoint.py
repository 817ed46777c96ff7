"""The port's render loop with checkpoints, resume and `want_var` against
rene_tpu's (`_render_pallas`, rene_tpu/render.py:316), and resumed
renders against unbroken ones bit for bit."""
import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rene_tpu import render as RR
from rene_tpu_torch import render as PR
from rene_tpu_torch import scenes
from rene_tpu_torch.scene import load_scene
from rene_tpu_torch.utils import checkpoint as CK

W, H = 6, 4
CONFIG = SimpleNamespace(film=SimpleNamespace(xresolution=W, yresolution=H))
IMAGES = ("color", "normal", "albedo")


class Stop(Exception):
    pass


def stub(pack, chunk_hint, calls):
    """A runner whose sums are made from its chunk seed (as
    tests/test_render.py's), recording (seed, chunk) per call."""
    def run(seed, chunk):
        calls.append((seed, chunk))
        g = np.random.default_rng(seed)
        n = chunk * pack
        sums = [torch.from_numpy((g.random((W * H, 3)) * n)
                                 .astype(np.float32)) for _ in range(3)]
        return {"radiance": sums[0], "normal": sums[1], "albedo": sums[2],
                "rays": float(n * W * H)}
    run.spp_mult, run.chunk_hint = pack, chunk_hint
    return run


def stop_at(k):
    """A progress callback that raises at chunk k (1-based)."""
    seen = []

    def progress(done, spp, ms):
        seen.append(done)
        if len(seen) == k:
            raise Stop
    return progress


def port_loop(run, spp, seed, **kw):
    return PR.render_loop(run, CONFIG, spp, seed, "cpu", **kw)


def assert_same(a, b, keys=IMAGES):
    for k in keys:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("want_var", [False, True])
@pytest.mark.parametrize("pack,hint,spp", [(1, 5, 37), (4, 3, 37),
                                           (4, 100, 30), (1, 100, 1)])
def test_loop_matches_reference(pack, hint, spp, want_var):
    """The same chunk seeds and sizes, film and varmean as the
    reference's loop driven by the same runner."""
    c_ref, c_port = [], []
    ref = RR._render_pallas(stub(pack, hint, c_ref), CONFIG, spp, 7, None,
                            False, None, want_var=want_var)
    out = port_loop(stub(pack, hint, c_port), spp, 7, want_var=want_var)
    assert c_port == c_ref and len(c_ref) >= 1
    assert_same(out, ref, IMAGES + (("varmean",) if want_var else ()))
    if want_var:
        # one chunk (spp 1) gives +inf, as the reference's
        assert np.isinf(out["varmean"]).all() == (len(c_ref) == 1)
    else:
        assert "varmean" not in out


@pytest.mark.parametrize("want_var", [False, True])
@pytest.mark.parametrize("pack,hint,spp,stop", [(1, 5, 37, 2), (4, 3, 37, 3),
                                                (1, 4, 20, 1)])
def test_resumed_loop_equals_unbroken(tmp_path, pack, hint, spp, stop,
                                      want_var):
    """Stopped by `progress` at a chunk (the snapshot holds the chunks
    before it), then resumed: the film and varmean of the unbroken
    reference loop, bit for bit, and the seeds it had not drawn (fault
    (a): the reference's resumed varmean covers only the chunks run since
    the resume)."""
    ck = str(tmp_path / "ck.npz")
    c_ref, c_stop, c_res = [], [], []
    ref = RR._render_pallas(stub(pack, hint, c_ref), CONFIG, spp, 3, None,
                            False, None, want_var=want_var)
    with pytest.raises(Stop):
        port_loop(stub(pack, hint, c_stop), spp, 3, checkpoint=ck,
                  progress=stop_at(stop), want_var=want_var)
    assert c_stop == c_ref[:stop]
    out = port_loop(stub(pack, hint, c_res), spp, 3, checkpoint=ck,
                    resume=True, want_var=want_var)
    assert c_res == c_ref[stop - 1:]
    assert_same(out, ref, IMAGES + (("varmean",) if want_var else ()))
    # the unbroken port loop without a checkpoint gives the same film
    assert_same(port_loop(stub(pack, hint, []), spp, 3, want_var=want_var),
                ref)


def test_resume_with_other_chunk_size_draws_the_stored_seeds(tmp_path):
    """A resuming runner of another chunk size draws past exactly the
    seeds the snapshot's chunks drew (fault (h): the reference recounts
    chunks of the resuming runner's size and would reuse a seed)."""
    ck = str(tmp_path / "ck.npz")
    seeds = np.random.default_rng(11)
    want = [int(seeds.integers(0, 2 ** 31, dtype=np.int32))
            for _ in range(8)]
    c1, c2 = [], []
    with pytest.raises(Stop):
        port_loop(stub(1, 2, c1), 20, 11, checkpoint=ck, progress=stop_at(3))
    port_loop(stub(1, 5, c2), 20, 11, checkpoint=ck, resume=True)
    assert [s for s, _ in c1] == want[:3]
    # chunks 1-2 (4 samples) were saved; the resume draws from seed 3 on
    assert [s for s, _ in c2] == want[2:2 + len(c2)]
    assert [c for _, c in c2] == [5, 5, 5, 1]


@pytest.mark.parametrize("n_chunks", [1, 2, 5])
def test_var_of_mean_matches_reference(n_chunks):
    g = np.random.default_rng(n_chunks)
    sum_x = (g.random((50, 3)) * 40).astype(np.float32)
    sq = (g.random((50, 3)) * 60).astype(np.float32)
    for n_total in (0, 1, 40):
        a = PR._var_of_mean(sum_x, sq, n_total, n_chunks)
        b = RR._var_of_mean(sum_x, sq, n_total, n_chunks)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert np.isinf(PR._var_of_mean(sum_x, sq, 40, 1)).all()


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    p = tmp_path_factory.mktemp("scene") / "box.pbrt"
    p.write_text(scenes.cornell_box(12, 8))
    return str(p)


@pytest.mark.parametrize("engine", ["pallas", "wave"])
def test_render_resumed_equals_unbroken(tmp_path, tiny_scene, engine):
    """A render on the CPU stopped at its second chunk by `progress` (the
    checkpoint then holds the first), resumed, equals an unbroken one bit
    for bit: color, normal, albedo and varmean (fault (a))."""
    ck = str(tmp_path / "ck.npz")
    kw = dict(spp=7, seed=4, device="cpu", engine=engine, want_var=True)
    full = PR.render(load_scene(tiny_scene), **kw)
    with pytest.raises(Stop):
        PR.render(load_scene(tiny_scene), checkpoint=ck,
                  progress=stop_at(2), **kw)
    with np.load(ck) as z:
        assert int(z["samples_done"]) == 3 and int(z["seeds"]) == 1
    res = PR.render(load_scene(tiny_scene), checkpoint=ck, resume=True, **kw)
    assert_same(res, full, IMAGES + ("varmean",))
    assert np.isfinite(full["varmean"]).all()


def test_mismatched_checkpoints_are_ignored(tmp_path, tiny_scene, caplog):
    """A wave checkpoint offered to the megakernel, one of another seed and
    a plain one offered to a want_var render are each ignored with a
    warning, and the render starts from 0 (fault (h))."""
    kw = dict(spp=2, device="cpu")
    cases = [(dict(engine="wave"), dict(engine="pallas")),
             (dict(seed=1), dict(seed=2)),
             (dict(), dict(want_var=True))]
    for i, (first, second) in enumerate(cases):
        ck = str(tmp_path / f"ck{i}.npz")
        PR.render(load_scene(tiny_scene), checkpoint=ck, **kw, **first)
        caplog.clear()
        seen = []
        with caplog.at_level(logging.INFO, "rene_tpu_torch"):
            PR.render(load_scene(tiny_scene), checkpoint=ck, resume=True,
                      progress=lambda d, s, ms: seen.append(d), **kw,
                      **second)
        msgs = [r.getMessage() for r in caplog.records]
        assert any("ignoring it" in m for m in msgs), (i, msgs)
        assert not any(m.startswith("resumed from") for m in msgs)
        # resumed, it would have run no chunk
        assert seen and seen[-1] == 2


def test_snapshot_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails part way leaves the previous snapshot whole and
    no temporary file; a good one leaves only the snapshot."""
    ck = str(tmp_path / "ck.npz")
    accum = {k: np.full((4, 3), i, np.float32)
             for i, k in enumerate(CK.SUMS)}
    CK.save_checkpoint(ck, accum, 8, "fp", 2, np.ones((4, 3), np.float32))
    assert os.listdir(tmp_path) == ["ck.npz"]

    def broken(f, **arrays):
        f.write(b"PK\x03\x04 part of a zip")
        raise OSError("disk full")
    monkeypatch.setattr(CK.np, "savez", broken)
    with pytest.raises(OSError):
        CK.save_checkpoint(ck, {k: v + 1 for k, v in accum.items()}, 16,
                           "fp", 4)
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["ck.npz"]
    snap = CK.load_checkpoint(ck, "fp")
    assert snap["samples_done"] == 8 and snap["seeds"] == 2
    np.testing.assert_array_equal(snap["accum"]["albedo"], accum["albedo"])
    np.testing.assert_array_equal(snap["sq_sum"], 1.0)
    assert CK.load_checkpoint(ck, "other") is None
