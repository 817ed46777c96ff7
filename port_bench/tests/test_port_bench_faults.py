"""The check sees a broken timed path, and passes a sound one.

Each test drives a whole run of a benchmark cell on the CPU at a tiny
film (the harness's look for a chip skipped; the port runs its plain
versions), with the runner under render_loop broken as a later change
might break it, and sees `correct` come out false; a sound run comes out
true. The bfloat16 control (the reference with its film in the precision
below float32) fails the cells' limits too. One chip, no exchange
between chips: that fault does not apply.
"""
import numpy as np
import pytest
import torch

from port_bench import check
from port_bench.reference import render as R

from pb_support import run_tiny, tiny_cell

CELLS = ["cornell.final"]
SPP = {"cornell.final": 8}


def wrapped(run, fn):
    """`run` with its sums replaced by fn(seed, n), its attributes kept."""
    def broken(seed, n):
        return fn(seed, n)
    broken.__dict__.update(run.__dict__)
    return broken


def unchanged(run):
    """A step that returns its state unchanged: the film's sums stay 0."""
    def fn(seed, n):
        out = run(seed, n)
        return {k: (torch.zeros_like(v) if torch.is_tensor(v) and v.ndim
                    else v) for k, v in out.items()}
    return wrapped(run, fn)


def half_batch(run):
    """Half of the samples left out, the mean taken over the rest."""
    def fn(seed, n):
        half = max(1, n // 2)
        out = run(seed, half)
        return {k: (v * (n / half) if torch.is_tensor(v) and v.ndim else v)
                for k, v in out.items()}
    return wrapped(run, fn)


def altered(run):
    """Every pixel's radiance altered by 1% where it is produced."""
    def fn(seed, n):
        out = dict(run(seed, n))
        out["radiance"] = out["radiance"] * 1.01
        return out
    return wrapped(run, fn)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = run_tiny(tiny_cell(workload, SPP[workload]))
    assert res["correct"] is True
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0.0 for v in res["checks"].values())


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    res = run_tiny(tiny_cell(workload, SPP[workload]), wrap_runner=fault)
    assert res["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_limits(workload, tmp_path):
    """The control at a tiny film, with the cell's own limits."""
    from port_bench import harness
    cell = tiny_cell(workload, 130)
    path = tmp_path / "scene.pbrt"
    path.write_text(harness.scene_text(cell.config))
    tabs = R.load_tables(str(path), "cpu")
    npix = tabs["width"] * tabs["height"]
    images = check.images_for(5, [0, 1], npix, 64)
    ref, ctl = R.film_pixels(tabs, cell.traffic["spp"], images,
                             (torch.float32, torch.bfloat16))
    ctl_kept = [np.concatenate([ctl[k][i] for k in
                                ("color", "normal", "albedo")], 1)
                for i in range(2)]
    values = check.compare(ctl_kept, ref)
    limits = cell.check["limits"]
    assert any(values[k] > limits[k] for k in values), values
