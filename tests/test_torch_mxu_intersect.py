"""The port's product intersector (rene_tpu_torch/ops/mxu_intersect.py)
against the reference's (rene_tpu/ops/mxu_intersect.py) on the CPU.

* The constant matrices B, P_on and P_dn: equal, element for element (both
  build them in numpy from the same float64 arithmetic).
* `intersect` on the triangles and rays of tests/test_mxu_intersect.py
  (ntri 8, 36, 500 against 800 rays): the two sides' products run in
  other libraries (XLA's dot against torch.matmul, both float32), which
  may sum a row's six terms in another order and move a side value by an
  ulp, so a ray whose side value is within an ulp of 0 may hit on one
  side only: hit sets equal on at least 99.8% of the rays (the
  reference's own test holds it to Möller–Trumbore by the same share).
  Where both hit: t within rtol 1e-5 and atol 1e-6 (t = pp / dn, each a
  product of four or three terms a few ulps apart; pp = k - o.n cancels
  where a ray starts near a plane, so near t = 0 the difference is an
  ulp of those terms, ~10, over dn, ~1: absolute); the same triangle on
  every such ray; u and v within 1e-5 (quotients of side values of a
  few units, an ulp or two apart).
* The reference test's barycentric and backface cases, each against the
  reference and its expected values; `occluded`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rene_tpu.ops.mxu_intersect import MXUIntersector as RefIntersector
from rene_tpu_torch.ops.mxu_intersect import MXUIntersector
from tests.test_intersect import random_rays, random_tris

torch.set_num_threads(2)

HIT_SHARE = 0.998   # rays whose hit or miss agrees
T_RTOL, T_ATOL = 1e-5, 1e-6
UV_ATOL = 1e-5
CPU = torch.device("cpu")


def _scene(ntri):
    """tests/test_mxu_intersect.py's triangles and rays for `ntri`."""
    tri = random_tris(ntri, seed=ntri + 40, scale=3.0)
    org, d = random_rays(800, seed=ntri + 41, scale=4.0)
    return tri, np.asarray(org), np.asarray(d)


@pytest.mark.parametrize("ntri", [8, 36, 500])
def test_constant_matrices_equal_the_reference(ntri):
    tri, _, _ = _scene(ntri)
    ref, port = RefIntersector(tri), MXUIntersector(tri, CPU)
    assert (port.num_tris, port.padded) == (ref.num_tris, ref.padded)
    for name in ("B", "P_on", "P_dn"):
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype == np.float32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("ntri", [8, 36, 500])
def test_intersect_matches_the_reference(ntri):
    tri, org, d = _scene(ntri)
    tmin, tmax = np.full(800, 1e-3, np.float32), np.full(800, 1e30,
                                                        np.float32)
    rt, rid, ru, rv = (np.asarray(x) for x in RefIntersector(tri).intersect(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), want_bary=True))
    port = MXUIntersector(tri, CPU)
    pt, pid, pu, pv = (x.numpy() for x in port.intersect(
        org, d, tmin, tmax, want_bary=True))
    hit_r, hit_p = rt < 1e29, pt < 1e29
    assert (hit_r == hit_p).mean() >= HIT_SHARE
    both = hit_r & hit_p
    assert both.sum() > 10   # the test must exercise hits
    np.testing.assert_allclose(pt[both], rt[both], rtol=T_RTOL,
                               atol=T_ATOL)
    np.testing.assert_array_equal(pid[both], rid[both])
    np.testing.assert_allclose(pu[both], ru[both], atol=UV_ATOL)
    np.testing.assert_allclose(pv[both], rv[both], atol=UV_ATOL)
    np.testing.assert_array_equal(pt[~hit_p], np.float32(1e30))
    occ = port.occluded(org, d, tmin, tmax).numpy()
    np.testing.assert_array_equal(occ, hit_p)


def _bary_case():
    # one triangle; rays straight down onto (x, y, 0): u = x / 2, v = y / 2
    tri = np.asarray([[[0.0, 0, 0], [2, 0, 0], [0, 2, 0]]], np.float32)
    pts = [(0.3, 0.4), (0.1, 0.05), (0.6, 0.3)]
    org = np.asarray([[2 * u_, 2 * v_, 1.0] for u_, v_ in pts], np.float32)
    d = np.broadcast_to(np.asarray([0, 0, -1.0], np.float32), (3, 3)).copy()
    return tri, org, d, np.full(3, 1e-3), np.full(3, 1e3), pts


def _backface_case():
    tri = np.asarray([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]]], np.float32)
    org = np.asarray([[0.2, 0.2, -1.0]], np.float32)
    d = np.asarray([[0.0, 0.0, 1.0]], np.float32)
    return tri, org, d, np.asarray([1e-3]), np.asarray([1e3]), [(0.2, 0.2)]


@pytest.mark.parametrize("case", ["barycentric", "backface"])
def test_reference_cases(case):
    """tests/test_mxu_intersect.py's barycentric case (the reference's
    (u, v) convention) and backface case (no culling): t = 1 and the
    expected (u, v), as the reference gives them."""
    tri, org, d, tmin, tmax, pts = (_bary_case() if case == "barycentric"
                                    else _backface_case())
    tmin, tmax = tmin.astype(np.float32), tmax.astype(np.float32)
    t, tid, u, v = (x.numpy() for x in MXUIntersector(
        tri, CPU).intersect(org, d, tmin, tmax, want_bary=True))
    rt, rid, ru, rv = (np.asarray(x) for x in RefIntersector(tri).intersect(
        jnp.asarray(org), jnp.asarray(d), jnp.asarray(tmin),
        jnp.asarray(tmax), want_bary=True))
    for i, (ue, ve) in enumerate(pts):
        assert float(t[i]) == pytest.approx(1.0, rel=1e-4)
        assert float(u[i]) == pytest.approx(ue, abs=1e-4)
        assert float(v[i]) == pytest.approx(ve, abs=1e-4)
    np.testing.assert_allclose(t, rt, rtol=T_RTOL, atol=T_ATOL)
    np.testing.assert_array_equal(tid, rid)
    np.testing.assert_allclose(u, ru, atol=UV_ATOL)
    np.testing.assert_allclose(v, rv, atol=UV_ATOL)
