"""The Mosaic probes P-r3n and P-r3w: plain versions, CUDA code, kernels.

* ops/probes.py against the scripts' own tables and formulas
  (scripts/tpu_session_r3n.py :37-66, tpu_session_r3w.py :40-99).
* The scripts' kernel bodies (k_p1 / k_p2 / k_p3, and k_vpu with its
  out-of-range column index and k_mxu_hi at a few reps) run here through
  `pl.pallas_call(..., interpret=True)` against the plain versions: P-r3n
  bit for bit, at every group and past the table's end (the dynamic slice
  clamps); k_vpu within 1e-6 (XLA contracts multiply-adds, torch does
  not), which shows that interpret mode clamps the index to column 7
  (ROADMAP Queue 3 (g)); k_mxu_hi within 1e-5 of |B| |R|.
* csrc/probes.cuh compiled with g++ against the plain versions bit for
  bit.
* On a card (`cuda`): each kernel against its plain version.
"""
import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rene_tpu_torch import kernels
from rene_tpu_torch.ops import probes as PR

torch.set_num_threads(2)


def _script_r3n_tables():
    # tpu_session_r3n.py :37-44, as written there
    nsup, grows = 16, 2
    perm = np.random.default_rng(0).permutation(nsup)
    box = np.zeros((nsup * grows, 128), np.float32)
    box[::grows, 126] = perm.astype(np.float32)
    box[::grows, 127] = perm.astype(np.int32).view(np.float32)
    geom = np.zeros((8, nsup * 128), np.float32)
    for j in range(nsup):
        geom[:, j * 128:(j + 1) * 128] = float(j)
    return perm, box, geom


def test_plain_probes_match_the_scripts():
    perm, box, geom = _script_r3n_tables()
    p, b, g = PR.r3n_tables()
    np.testing.assert_array_equal(p, perm)
    np.testing.assert_array_equal(b.numpy(), box)
    np.testing.assert_array_equal(g.numpy(), geom)
    for mode in PR.R3N_MODES:
        for si in range(16):
            out = PR.rowslice_ref(mode, si, b, g)
            assert out.shape == (8, 128)
            assert (out == float(perm[si])).all(), (mode, si)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((384, 8)).astype(np.float32)
    R = rng.standard_normal((8, 1024)).astype(np.float32)
    b, r = PR.r3w_inputs()
    np.testing.assert_array_equal(b.numpy(), B)
    np.testing.assert_array_equal(r.numpy(), R)
    np.testing.assert_allclose(PR.mxu_ref("hi", b, r).numpy(),
                               (B.astype(np.float64) @ R), rtol=1e-6,
                               atol=1e-6)
    scale = PR.product_scale(b, r)
    err = ((PR.mxu_ref("def", b, r) - PR.mxu_ref("hi", b, r)).abs()
           / scale).max()
    assert 1e-4 < float(err) <= 1e-2
    # the card's "def" limit tells a bf16 pass from one at full precision
    from rene_tpu_torch.probes import R3W_TOL
    assert float(err) > 100 * R3W_TOL["def"]
    # the chain in float32 numpy, k clamped to column 7
    x = np.float32(1.0)
    for _ in range(3):
        for k in range(32):
            c0, c1 = B[0, min(k, 7)], B[1, min(k, 7)]
            x = x * c0 + c1
            x = min(x * c1 + c0, x)
            x = x * c0 + c1
            x = max(x, x * c1)
            x = x * c0 + c1
            x = min(x, x * c1 + c0)
    v = PR.mxu_ref("vpu", b, r, 3)
    assert v.shape == (8, 128) and (v == x).all()
    assert PR.mxu_flops("hi", b, r) == 3 * 2 * 384 * 1024 * 8
    assert PR.mxu_flops("def", b, r) == 2 * 384 * 1024 * 8 == 6291456
    with pytest.raises(ValueError):
        PR.rowslice_ref(4, 0, b, g)
    with pytest.raises(ValueError):
        PR.mxu_ref("lo", b, r)


def _pallas_r3n(mode, si, box, geom):
    """tpu_session_r3n.py's kernel `mode` (:46-66, as written there) in
    interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    grows = 2

    def k_p1(sc, box_ref, geom_ref, o_ref):
        si = sc[0]
        brow = box_ref[pl.ds(si * grows, grows), :]
        g = brow[0, 126].astype(jnp.int32)
        o_ref[...] = geom_ref[:, pl.ds(g * 128, 128)]

    def k_p2(sc, box_ref, geom_ref, o_ref):
        si = sc[0]
        brow = box_ref[pl.ds(si * grows, grows), :]
        g = jax.lax.bitcast_convert_type(brow[0, 127], jnp.int32)
        o_ref[...] = geom_ref[:, pl.ds(g * 128, 128)]

    def k_p3(sc, box_ref, geom_ref, o_ref):
        d = geom_ref[:, pl.ds(0, 128)] - 3.0
        oct_ = (4 * (d[0, 0] < 0).astype(jnp.int32)
                + 2 * (d[0, 0] < 0).astype(jnp.int32)
                + (d[0, 0] < 0).astype(jnp.int32))
        si = sc[0] + oct_ - 7
        brow = box_ref[pl.ds(si * grows, grows), :]
        g = brow[0, 126].astype(jnp.int32)
        o_ref[...] = geom_ref[:, pl.ds(g * 128, 128)]

    f = pl.pallas_call(
        {1: k_p1, 2: k_p2, 3: k_p3}[mode],
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(box.shape, lambda: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(geom.shape, lambda: (0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)
    return np.asarray(f(jnp.asarray([si, 0, 0], jnp.int32),
                        jnp.asarray(box), jnp.asarray(geom)))


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_r3n_interpret_kernels_match_plain_version(mode):
    """Every group, then groups and block indices past the tables' ends
    (box rows of group 17 and 40; geom blocks 16 and 99): the same block
    bit for bit, so the plain version's clamps are the dynamic slice's."""
    _, box, geom = _script_r3n_tables()
    big = box.copy()
    big[6, 126] = 16.0
    big[8, 126] = 99.0
    big[6, 127] = np.int32(16).view(np.float32)
    big[8, 127] = np.int32(99).view(np.float32)
    for tabs, sis in ((box, list(range(16)) + [17, 40]), (big, [3, 4])):
        bt, gt = torch.from_numpy(tabs), torch.from_numpy(geom)
        for si in sis:
            want = PR.rowslice_ref(mode, si, bt, gt).numpy()
            got = _pallas_r3n(mode, si, tabs, geom)
            np.testing.assert_array_equal(got, want, err_msg=f"si {si}")


def test_r3w_interpret_kernels_match_plain_version():
    """k_vpu (its index past column 7 as written) and k_mxu_hi at 3 reps
    in interpret mode against the plain versions."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    reps = 3
    b, r = PR.r3w_inputs()

    def k_mxu_hi(b_ref, r_ref, o_ref):
        def body(i, acc):
            s = jax.lax.dot_general(
                b_ref[...], r_ref[...] + acc[0, 0] * 0.0,
                (((1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)
            return s[:8, :]
        o_ref[...] = jax.lax.fori_loop(0, reps, body,
                                       jnp.zeros((8, 1024), jnp.float32))

    def k_vpu(b_ref, r_ref, o_ref):
        def body(i, acc):
            x = acc
            for k in range(32):
                c0 = b_ref[0, k]
                c1 = b_ref[1, k]
                x = x * c0 + c1
                x = jnp.minimum(x * c1 + c0, x)
                x = x * c0 + c1
                x = jnp.maximum(x, x * c1)
                x = x * c0 + c1
                x = jnp.minimum(x, x * c1 + c0)
            return x
        r8 = r_ref[...].reshape(8, 8, 128)[0]
        o_ref[...] = jax.lax.fori_loop(0, reps, body, r8 * 0.0 + 1.0)

    def call(kern, out_shape):
        return np.asarray(pl.pallas_call(
            kern,
            in_specs=[pl.BlockSpec(a.shape, lambda: (0, 0),
                                   memory_space=pltpu.VMEM) for a in (b, r)],
            out_specs=pl.BlockSpec(out_shape, lambda: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
            interpret=True)(jnp.asarray(b.numpy()), jnp.asarray(r.numpy())))

    vpu = call(k_vpu, (8, 128))
    np.testing.assert_allclose(vpu, PR.mxu_ref("vpu", b, r, reps).numpy(),
                               rtol=1e-6, atol=1e-6)
    # a flat read past column 7 (Mosaic's lane padding, here zeros) would
    # give another value
    assert abs(float(vpu[0, 0]) - float(_flat_chain(b.numpy(), reps))) > 1e-3
    hi = call(k_mxu_hi, (8, 1024))
    scale = PR.product_scale(b, r)[:8].numpy()
    want = PR.mxu_ref("hi", b, r, reps)[:8].numpy()
    assert (np.abs(hi - want) / scale).max() <= 1e-5


def _flat_chain(B, reps):
    """k_vpu's chain reading columns 8-31 as zeros."""
    flat = np.zeros((2, 32), np.float32)
    flat[:, :8] = B[:2]
    x = np.float32(1.0)
    for _ in range(reps):
        for k in range(32):
            c0, c1 = flat[0, k], flat[1, k]
            x = x * c0 + c1
            x = min(x * c1 + c0, x)
            x = x * c0 + c1
            x = max(x, x * c1)
            x = x * c0 + c1
            x = min(x, x * c1 + c0)
    return x


HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
static inline uint32_t __float_as_uint(float f) {
  uint32_t u; memcpy(&u, &f, 4); return u;
}
#include "probes.cuh"
extern "C" int group(int mode, int si, const float* box, int box_rows,
                     const float* geom, int geom_cols) {
  return rowslice_group(mode, si, box, box_rows, geom, geom_cols);
}
extern "C" void chain(const float* b, const float* r, int reps, float* out) {
  for (int i = 0; i < 1024; ++i)
    out[i] = vpu_chain(add_rn(mul_rn(r[i], 0.0f), 1.0f), b, reps);
}
"""


@pytest.fixture(scope="module")
def probe_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the probes' per-thread code")
    d = tmp_path_factory.mktemp("probes")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libprobes.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
         f"-I{kernels.CSRC}", "-o", str(so), str(d / "harness.cpp")],
        capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.group.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.group.restype = ctypes.c_int
    lib.chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
    lib.chain.restype = None
    return lib


def test_probe_code_matches_plain_version(probe_lib):
    """probes.cuh rowslice_group (g++) picks the plain version's block for
    every mode and group, past the ends too; vpu_chain equals the plain
    chain bit for bit at 5 reps."""
    _, box, geom = PR.r3n_tables()
    for mode in PR.R3N_MODES:
        for si in list(range(-3, 20)):
            g = probe_lib.group(mode, si, box.data_ptr(), box.shape[0],
                                geom.data_ptr(), geom.shape[1])
            want = PR.rowslice_ref(mode, si, box, geom)
            assert torch.equal(geom[:, g * 128:(g + 1) * 128], want), \
                (mode, si)
    b, r = PR.r3w_inputs()
    out = torch.empty(1024, dtype=torch.float32)
    probe_lib.chain(b.data_ptr(), r.data_ptr(), 5, out.data_ptr())
    want = PR.mxu_ref("vpu", b, r, 5).reshape(-1)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def test_probe_wrappers_on_cpu_run_plain_versions():
    perm, box, geom = PR.r3n_tables()
    b, r = PR.r3w_inputs()
    before = dict(kernels.launches)
    assert torch.equal(kernels.rowslice_probe(2, 3, box, geom),
                       PR.rowslice_ref(2, 3, box, geom))
    assert torch.equal(kernels.mxu_probe("hi", b, r, 2),
                       PR.mxu_ref("hi", b, r, 2))
    assert kernels.launches == before


@pytest.mark.cuda
def test_probe_kernels_on_card_match_plain_version():
    """On a CUDA card: P-r3n bit for bit for its three modes and the
    script's groups; P-r3w's hi and def within 1e-5 of |B| |R| of
    their plain versions at 200 reps, vpu bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from rene_tpu_torch import probes
    dev = torch.device("cuda", 0)
    before = dict(kernels.launches)
    n = probes.r3n(dev)
    w = probes.r3w(dev)
    assert all(ok for ok, _ in n.values()), n
    assert all(v["ok"] for v in w.values()), \
        {k: v["err"] for k, v in w.items()}
    assert kernels.launches["rowslice_probe"] > before["rowslice_probe"]
    for k in kernels.MXU_KINDS:
        assert kernels.launches["mxu_probe_" + k] \
            > before["mxu_probe_" + k]
