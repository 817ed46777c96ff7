"""The chunk loop's waits on the device (rene_tpu_torch/render.py): the
ray counts read once, after the last chunk, unless `progress` or
`checkpoint` needs each chunk's end; the films divided on the sums'
device equal numpy's bit for bit; on the card, the films of one image
stay as they were while the next renders."""
import functools
import math
import operator
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rene_tpu_torch import render as R
from rene_tpu_torch import scenes, trace
from rene_tpu_torch.scene import build_device_scene, load_scene
from rene_tpu_torch.utils.checkpoint import SUMS

W, H = 6, 4
CONFIG = SimpleNamespace(film=SimpleNamespace(xresolution=W, yresolution=H))
IMAGES = ("color", "normal", "albedo")
SPP, HINT = 95, 10      # ten chunks, the last of five samples
COUNTS = [0.1] * 10     # added in order: 0.9999999999999999, not 1.0


class Count:
    """A chunk's ray count that records when it is read."""

    def __init__(self, value, chunk, events):
        self.value, self.chunk, self.events = value, chunk, events

    def __float__(self):
        self.events.append(("read", self.chunk))
        return self.value


def counting_runner(events):
    """A runner whose sums are made from its chunk seed and whose ray
    counts are `Count`s of COUNTS; it records each launch."""
    def run(seed, chunk):
        i = sum(1 for e in events if e[0] == "launch")
        events.append(("launch", i))
        g = np.random.default_rng(seed)
        sums = {k: torch.from_numpy((g.random((W * H, 3)) * chunk)
                                    .astype(np.float32)) for k in SUMS}
        return {**sums, "rays": Count(COUNTS[i], i, events)}
    run.spp_mult, run.chunk_hint = 1, HINT
    return run


@pytest.mark.parametrize("caller", ["none", "progress", "checkpoint"])
def test_counts_are_read_at_the_end_unless_a_chunk_end_is_needed(
        caller, tmp_path):
    events = []
    kw = {"none": {},
          "progress": {"progress": lambda done, spp, ms: None},
          "checkpoint": {"checkpoint": str(tmp_path / "ck.npz")}}[caller]
    out = R.render_loop(counting_runner(events), CONFIG, SPP, 3, "cpu",
                        **kw)
    n = len(COUNTS)
    launches = [("launch", i) for i in range(n)]
    reads = [("read", i) for i in range(n)]
    if caller == "none":
        assert events == launches + reads
    else:
        assert events == [e for pair in zip(launches, reads) for e in pair]
    in_order = functools.reduce(operator.add, COUNTS, 0.0)
    assert in_order != math.fsum(COUNTS)    # the order shows
    assert out["total_rays"] == in_order


@pytest.mark.parametrize("done", [1024, 100, 24, 3])
def test_film_from_tensors_is_the_numpy_film(done):
    """`divide`'s films, made on the sums' device, against `film_result`'s
    numpy divide of the same sums, bit for bit."""
    g = np.random.default_rng(done)
    sums = {k: (g.random((W * H, 3)) * done * 3.0).astype(np.float32)
            for k in SUMS}
    want = R.film_result(CONFIG, sums, None, done, 2)
    means = {k: v.numpy() for k, v in
             R.divide({k: torch.from_numpy(v) for k, v in sums.items()},
                      done).items()}
    got = R.film_result(CONFIG, sums, None, done, 2, means)
    for k in IMAGES:
        assert got[k].dtype == want[k].dtype == np.float32
        assert np.array_equal(got[k].view(np.uint32),
                              want[k].view(np.uint32)), k


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("want_var", [False, True])
def test_card_films_are_the_host_films_and_stay_put(card, tmp_path,
                                                    want_var):
    """On the card: render_loop's films (divided there, one pinned
    readback) are the host film of the same sums bit for bit, with the
    same ray count; one wait an image; the films handed back for one
    image are unchanged after the next has rendered."""
    from rene_tpu_torch.integrators.mega_path import make_mega_batch_fn
    path = tmp_path / "box.pbrt"
    path.write_text(scenes.cornell_box(96, 64))
    buffers_np, config = build_device_scene(load_scene(str(path)))
    spp = 24
    run = make_mega_batch_fn(buffers_np, config, "cuda", spp_hint=spp)
    keys = IMAGES + (("varmean",) if want_var else ())
    with trace.profiled() as prof:
        first = R.render_loop(run, config, spp, 5, "cuda", want_var=want_var)
    # the host's spans (a span with device work in it shows twice)
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CPU]
    assert names.count("rene.loop.wait") == names.count(
        "rene.loop.image") == 1
    kept = {k: first[k].copy() for k in keys}
    c = R.run_chunks(run, config, spp, 5, "cuda", want_var=want_var)
    host = {k: R._host(v) for k, v in c.accum.items()}
    want = R.film_result(config, host,
                         None if c.sq_sum is None else R._host(c.sq_sum),
                         c.done, c.seeds)
    for k in keys:
        assert first[k].dtype == np.float32
        assert np.array_equal(first[k].view(np.uint32),
                              want[k].view(np.uint32)), k
    assert first["total_rays"] == c.total_rays > 0
    second = R.render_loop(run, config, spp, 6, "cuda", want_var=want_var)
    assert not np.array_equal(second["color"], first["color"])
    for k in keys:
        assert np.array_equal(first[k].view(np.uint32),
                              kept[k].view(np.uint32)), k
