"""rene_tpu_torch.ops against rene_tpu.ops and plain numpy.

Inputs are drawn with numpy from a fixed seed and fed to both packages.
Tolerances: the random stream is integer math and must match bit for
bit; the float helpers run the same formulas in float32 on two backends
(XLA's CPU kernels vs torch's), so they agree to a few float32 ulps
(rtol 1e-5), except the GGX sampler, whose two JAX spellings differ in
association (rtol 1e-4), and the two Fresnel terms. Those subtract
near-equal products (`1 - sin_t^2` close to total internal reflection,
`et c - ei cos_t` for close indices, `a2b2 + t0` for a weak absorber), so
the rounding of one step is amplified by the cancellation and how a
backend contracts its multiply-adds moves the result by far more than an
ulp of it. Each package is therefore held to a float64 evaluation of the
formula within a running first-order bound of the float32 rounding
errors (`_Err`), and the two to each other within the sum of their
bounds.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rene_tpu.ops import fresnel as jfr
from rene_tpu.ops import microfacet as jmf
from rene_tpu.ops.vec3 import V3
from rene_tpu_torch.ops import fresnel, microfacet, rng, vec3

torch.set_num_threads(2)

RTOL = 1e-5


def _np_xorshift(pix, seed, draws):
    """Reference stream in numpy uint32 arithmetic."""
    pix = pix.astype(np.uint32)
    with np.errstate(over="ignore"):
        seed_u = np.uint32(seed) + (pix // np.uint32(8192)) * np.uint32(65537)
        st = (pix * np.uint32(2654435761)) ^ seed_u | np.uint32(1)
        out = []
        for _ in range(draws):
            st = st ^ (st << np.uint32(13))
            st = st ^ (st >> np.uint32(17))
            st = st ^ (st << np.uint32(5))
            out.append(((st >> np.uint32(9)) | np.uint32(0x3F800000))
                       .view(np.float32) - np.float32(1.0))
    return np.stack(out)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1])
def test_rng_stream_bit_exact(seed):
    pix = np.random.default_rng(seed).integers(0, 1 << 21, 4096)
    ref = _np_xorshift(pix, seed, 12)
    st = rng.seed_state(torch.as_tensor(pix), seed)
    got = []
    for _ in range(12):
        u, st = rng.uniform(st)
        got.append(u.numpy())
    got = np.stack(got)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def _unit(rng_, n, upper=False):
    v = rng_.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    if upper:
        v[:, 2] = np.abs(v[:, 2]) + 1e-3
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v.astype(np.float32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


U32 = 2.0 ** -24     # unit roundoff of float32
ERR_SLACK = 4.0      # over the first-order bound: second-order terms, and
                     # an input of a select that a backend rounds apart


class _Err:
    """A float64 value with a bound on the absolute error of its float32
    evaluation: each operation adds its own rounding (U32 |result|) to
    the propagated errors of its operands. Contracting a multiply-add
    into an FMA only drops one of those roundings."""

    def __init__(self, v, e=None):
        self.v = np.asarray(v, np.float64)
        self.e = np.zeros_like(self.v) if e is None else e

    @staticmethod
    def of(x):
        return x if isinstance(x, _Err) else _Err(
            np.float64(np.float32(x)))

    def _new(self, v, e):
        return _Err(v, e + U32 * np.abs(v))

    def __add__(self, o):
        o = _Err.of(o)
        return self._new(self.v + o.v, self.e + o.e)

    __radd__ = __add__

    def __sub__(self, o):
        o = _Err.of(o)
        return self._new(self.v - o.v, self.e + o.e)

    def __rsub__(self, o):
        return _Err.of(o) - self

    def __mul__(self, o):
        o = _Err.of(o)
        return self._new(self.v * o.v, np.abs(self.v) * o.e
                         + np.abs(o.v) * self.e + self.e * o.e)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = _Err.of(o)
        den = np.maximum(np.abs(o.v) - o.e, 1e-300)
        q = self.v / o.v
        return self._new(q, (self.e + np.abs(q) * o.e) / den)

    def sqrt_pos(self):
        """sqrt(max(x, 0)): the width of the image of [x - e, x + e]."""
        lo = np.sqrt(np.maximum(self.v - self.e, 0.0))
        hi = np.sqrt(np.maximum(self.v + self.e, 0.0))
        v = np.sqrt(np.maximum(self.v, 0.0))
        return self._new(v, np.maximum(hi - v, v - lo))

    def at_least(self, lo):
        return _Err(np.maximum(self.v, lo), self.e)


def _fr_dielectric_f64(cos_i, eta_i, eta_t):
    """fr_dielectric in float64 on the float32 inputs, with the float32
    error bound; where sin_t is within its error of 1 either side of the
    total-internal-reflection select is right."""
    c = np.clip(cos_i.astype(np.float64), -1.0, 1.0)
    entering = c > 0.0
    ei = _Err(np.where(entering, eta_i, eta_t))
    et = _Err(np.where(entering, eta_t, eta_i))
    c = _Err(np.abs(c))
    sin_i = (1.0 - c * c).sqrt_pos()
    sin_t = ei / et * sin_i
    cos_t = (1.0 - sin_t * sin_t).sqrt_pos()
    rp = ((et * c) - (ei * cos_t)) / ((et * c) + (ei * cos_t)).at_least(1e-20)
    rs = ((ei * c) - (et * cos_t)) / ((ei * c) + (et * cos_t)).at_least(1e-20)
    f = 0.5 * (rp * rp + rs * rs)
    tir = sin_t.v >= 1.0
    edge = np.abs(sin_t.v - 1.0) <= ERR_SLACK * sin_t.e
    val = np.where(tir, 1.0, f.v)
    return val, np.where(tir, 0.0, f.e) + np.where(edge, np.abs(1.0 - f.v),
                                                   0.0)


def _fr_conductor_f64(c2, s2, eta, k, c):
    c2, s2, eta, k, c = (_Err(np.float64(a)) for a in (c2, s2, eta, k, c))
    eta2 = eta * eta
    etk2 = k * k
    t0 = eta2 - etk2 - s2
    a2b2 = (t0 * t0 + 4.0 * eta2 * etk2).sqrt_pos()
    t1 = a2b2 + c2
    a_ = (0.5 * (a2b2 + t0)).sqrt_pos()
    t2 = 2.0 * c * a_
    rs = (t1 - t2) / (t1 + t2).at_least(1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4).at_least(1e-20)
    out = 0.5 * (rp + rs)
    return out.v, out.e


def _hold_to_f64(got, ref, val, bound):
    """Both packages within ERR_SLACK bounds (plus a float32 rounding of
    the result) of the float64 value, and within the sum of each other.
    The bound must stay a real test: small on nearly every input."""
    tol = ERR_SLACK * bound + U32 * np.abs(val) + 1e-30
    assert np.median(tol) < 1e-5 and (tol < 1e-4).mean() > 0.99, \
        (np.median(tol), (tol < 1e-4).mean())
    for name, x in (("rene_tpu_torch", got), ("rene_tpu", ref)):
        bad = np.abs(x.astype(np.float64) - val) > tol
        assert not bad.any(), (name, np.nonzero(bad)[0][:5], x[bad][:5],
                               val[bad][:5], tol[bad][:5])
    assert (np.abs(got.astype(np.float64) - ref) <= 2.0 * tol).all()


def test_fr_dielectric_matches_reference():
    r = np.random.default_rng(1)
    cos_i = r.uniform(-1, 1, 4096).astype(np.float32)
    eta_i = r.uniform(1.0, 2.0, 4096).astype(np.float32)
    eta_t = r.uniform(1.0, 2.0, 4096).astype(np.float32)
    ref = np.asarray(jfr.fr_dielectric(jnp.asarray(cos_i), jnp.asarray(eta_i),
                                       jnp.asarray(eta_t)))
    got = fresnel.fr_dielectric(_t(cos_i), _t(eta_i), _t(eta_t)).numpy()
    val, bound = _fr_dielectric_f64(cos_i, eta_i, eta_t)
    assert (val == 1.0).mean() > 0.05 and (val < 1e-3).mean() > 0.05
    _hold_to_f64(got, ref, val, bound)


def test_fr_conductor_matches_reference():
    r = np.random.default_rng(2)
    c = r.uniform(0, 1, 4096).astype(np.float32)
    eta = r.uniform(0.1, 3.0, 4096).astype(np.float32)
    k = r.uniform(0.0, 5.0, 4096).astype(np.float32)
    c2 = c * c
    s2 = (1.0 - c2).astype(np.float32)
    ref = np.asarray(jfr._fr_conductor_channel(
        jnp.asarray(c2), jnp.asarray(s2), jnp.asarray(eta), jnp.asarray(k),
        jnp.asarray(c)))
    got = fresnel.fr_conductor_ch(_t(c2), _t(s2), _t(eta), _t(k),
                                  _t(c)).numpy()
    _hold_to_f64(got, ref, *_fr_conductor_f64(c2, s2, eta, k, c))


def _mf_inputs(seed, n=4096):
    r = np.random.default_rng(seed)
    ax = r.uniform(0.05, 0.9, n).astype(np.float32)
    ay = r.uniform(0.05, 0.9, n).astype(np.float32)
    w = _unit(r, n, upper=True)
    h = _unit(r, n, upper=True)
    u1 = r.uniform(0, 1, n).astype(np.float32)
    u2 = r.uniform(0, 1, n).astype(np.float32)
    return ax, ay, w, h, u1, u2


def _jv(a):
    return V3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_microfacet_d_lambda_pdf_match_reference(dist, monkeypatch):
    monkeypatch.setenv("RENE_MF_DIST", dist)
    beck = dist == "beckmann"
    ax, ay, w, h, _, _ = _mf_inputs(3)
    jax_ax, jax_ay = jnp.asarray(ax), jnp.asarray(ay)
    d_ref = np.asarray(jmf.tr_d(jax_ax, jax_ay, _jv(h)))
    d = microfacet.ggx_d(_t(ax), _t(ay), *map(_t, h.T), beck).numpy()
    np.testing.assert_allclose(d, d_ref, rtol=RTOL, atol=1e-6)
    lam_ref = np.asarray(jmf.tr_lambda(jax_ax, jax_ay, _jv(w)))
    lam = microfacet.ggx_lambda(_t(ax), _t(ay), *map(_t, w.T), beck).numpy()
    np.testing.assert_allclose(lam, lam_ref, rtol=RTOL, atol=1e-6)
    pdf_ref = np.asarray(jmf.tr_pdf(jax_ax, jax_ay, _jv(w), _jv(h)))
    pdf = microfacet.wh_pdf(_t(ax), _t(ay), *map(_t, w.T), *map(_t, h.T),
                            _t(d), beck).numpy()
    np.testing.assert_allclose(pdf, pdf_ref, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("dist", ["ggx", "beckmann"])
def test_microfacet_sample_matches_reference(dist, monkeypatch):
    monkeypatch.setenv("RENE_MF_DIST", dist)
    beck = dist == "beckmann"
    ax, ay, w, _, u1, u2 = _mf_inputs(4)
    ref = np.asarray(jmf.tr_sample_wh(jnp.asarray(ax), jnp.asarray(ay),
                                      _jv(w), jnp.asarray(u1),
                                      jnp.asarray(u2)).to_array())
    got = torch.stack(microfacet.sample_wh(
        _t(ax), _t(ay), *map(_t, w.T), _t(u1), _t(u2), beck), -1).numpy()
    # the megakernel skips the frame rotation of the near-normal special
    # case (stretched cos > 0.9999) that rene_tpu.ops applies; compare
    # where the two compute the same formula
    st = np.stack([ax * w[:, 0], ay * w[:, 1], w[:, 2]], -1)
    same = st[:, 2] / np.linalg.norm(st, axis=1) <= 0.9999
    assert same.mean() > 0.9
    np.testing.assert_allclose(got[same], ref[same], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


def test_onb_and_frames():
    r = np.random.default_rng(5)
    n = _t(_unit(r, 4096))
    a = _t(_unit(r, 4096))
    ux, uy, uz, vx, vy, vz = vec3.onb_from_w(n[:, 0], n[:, 1], n[:, 2])
    u = torch.stack([ux, uy, uz], -1)
    v = torch.stack([vx, vy, vz], -1)
    for x, y in ((u, v), (u, n), (v, n)):
        assert (x * y).sum(-1).abs().max() < 1e-5
    for x in (u, v):
        assert ((x * x).sum(-1) - 1).abs().max() < 1e-5
    frame = (ux, uy, uz, vx, vy, vz, n[:, 0], n[:, 1], n[:, 2])
    back = vec3.to_world(*frame, *vec3.to_local(*frame, *a.T))
    torch.testing.assert_close(torch.stack(back, -1), a, rtol=0, atol=1e-5)
    nx, ny, nz = vec3.normalize3(*(3.0 * a).T)
    torch.testing.assert_close(torch.stack([nx, ny, nz], -1), a,
                               rtol=0, atol=1e-6)
