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
import re
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
// every (row, k), (k, col) or (row, col) of the fragment maps, and the
// shared-memory offsets of the wgmma B operand (R3W_WG_ROWS columns)
extern "C" void maps(int* wa, int* wd, int* wb, int* ma, int* mb, int* md) {
  for (int tid = 0; tid < 128; ++tid) {
    for (int i = 0; i < 4; ++i)
      wg_a_tf32(tid, i, wa[(tid * 4 + i) * 2], wa[(tid * 4 + i) * 2 + 1]);
    for (int i = 0; i < R3W_WG_ROWS / 2; ++i)
      wg_d(tid, i, wd[(tid * R3W_WG_ROWS / 2 + i) * 2],
           wd[(tid * R3W_WG_ROWS / 2 + i) * 2 + 1]);
  }
  for (int k = 0; k < R3W_K; ++k)
    for (int col = 0; col < R3W_WG_ROWS; ++col)
      wb[k * R3W_WG_ROWS + col] = wg_b_offset(k, col);
  for (int lane = 0; lane < 32; ++lane) {
    for (int i = 0; i < 4; ++i)
      mma_d(lane, i, md[(lane * 4 + i) * 2], md[(lane * 4 + i) * 2 + 1]);
    for (int i = 0; i < 2; ++i) {
      mma_b_bf16(lane, i, mb[(lane * 2 + i) * 2], mb[(lane * 2 + i) * 2 + 1]);
      for (int h = 0; h < 2; ++h)
        mma_a_bf16(lane, i, h, ma[((lane * 2 + i) * 2 + h) * 2],
                   ma[((lane * 2 + i) * 2 + h) * 2 + 1]);
    }
  }
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
    lib.maps.argtypes = [ctypes.c_void_p] * 6
    lib.maps.restype = None
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


@pytest.mark.parametrize("reps", [1, PR.R3W_REPS])
def test_vpu_chain_matches_plain_version(probe_lib, reps):
    """The card's vpu chain (probes.cuh vpu_chain: its constants read once,
    min and max as one NaN-keeping operation each; g++ takes the host
    branch of min_nan / max_nan) bit for bit against the plain version at
    one rep and at the script's 200."""
    b, r = PR.r3w_inputs()
    out = torch.empty(1024, dtype=torch.float32)
    probe_lib.chain(b.data_ptr(), r.data_ptr(), reps, out.data_ptr())
    want = PR.mxu_ref("vpu", b, r, reps).reshape(-1)
    assert bool(torch.isfinite(want).all())
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


# the PTX ISA's fragments, written out here apart from probes.cuh: which
# thread (lane) and register (and bf16 half) of a warpgroup (warp) holds
# element (row, k) of A, (k, col) of B, (row, col) of D; and the byte
# offset of B's (k, col) in shared memory for a K-major TF32 descriptor
# of leading byte offset LBO (along k, between 16-byte core-matrix rows)
# and stride byte offset SBO (between groups of 8 columns)
def _isa_wg_a(row, k):
    """wgmma A, TF32, 64 x 8 -> (thread, register)."""
    return (32 * (row // 16) + 4 * (row % 8) + k % 4,
            (row % 16) // 8 + 2 * (k // 4))


def _isa_wg_d(row, col):
    return 32 * (row // 16) + 4 * (row % 8) + (col % 8) // 2, \
        4 * (col // 8) + 2 * ((row % 16) // 8) + col % 2


def _isa_b_offset(k, col, lbo, sbo):
    return (col // 8) * sbo + (4 * k // 16) * lbo + (col % 8) * 16 \
        + (4 * k) % 16


def _isa_mma(what, a, b):
    """mma.m16n8k8 bf16: A (row a, k b), B (k a, col b), D (row a, col b)
    -> (lane, register, half)."""
    if what == "a":
        return 4 * (a % 8) + b // 2, a // 8, b % 2
    if what == "b":
        return 4 * b + a // 2, 0, a % 2
    return 4 * (a % 8) + b // 2, 2 * (a // 8) + b % 2, 0


def _defines():
    text = (kernels.CSRC / "probes.cuh").read_text()
    return {k: int(re.search(rf"#define {k} (\d+)", text).group(1))
            for k in ("R3W_LBO", "R3W_SBO", "R3W_WG_ROWS")}


def _maps(probe_lib):
    """probes.cuh's maps as the harness writes them out: wgmma A, D and
    B offsets, mma.sync A, B and D."""
    n = _defines()["R3W_WG_ROWS"]
    arrs = [np.zeros(k, np.int32) for k in (
        128 * 4 * 2, 128 * n, 8 * n, 32 * 8, 32 * 4, 32 * 8)]
    probe_lib.maps(*(a.ctypes.data for a in arrs))
    return arrs


@pytest.mark.parametrize("what", ["wgmma_tf32", "mma_bf16"])
def test_fragment_maps_rebuild_the_product(probe_lib, what):
    """The kernels place b and r by probes.cuh's maps (registers of A and
    B, B's shared-memory offsets) and read the product by its D map. Here
    the values go where those maps say, a model of the instruction takes
    them where the PTX ISA says it does (written out above, apart from
    probes.cuh), and the product read back by the D map is b @ r of the
    tile: hi's transposed wgmma tile (64 rays x R3W_WG_ROWS rows of b)
    and def's 16 x 8 mma.sync tile. A map that puts one value in the
    wrong register, half or byte fails."""
    wa, wd, wb, ma, mb, md = _maps(probe_lib)
    defs = _defines()
    lbo, sbo, n = defs["R3W_LBO"], defs["R3W_SBO"], defs["R3W_WG_ROWS"]
    rng = np.random.default_rng(7)
    if what == "wgmma_tf32":
        bt = rng.standard_normal((n, 8))     # n rows of b
        rt = rng.standard_normal((8, 64))    # 64 rays of r
        # the kernel's side: registers of A (r^T) and shared memory of B
        # (b^T) by probes.cuh
        regs = {}
        for idx in range(128 * 4):
            row, k = wa[2 * idx:2 * idx + 2]
            regs[idx // 4, idx % 4] = rt[k, row]
        smem = {}
        for k in range(8):
            for col in range(n):
                off = int(wb[k * n + col])
                assert off not in smem
                smem[off] = bt[col, k]
        # the instruction, as the ISA reads its operands
        a = np.array([[regs[_isa_wg_a(row, k)] for k in range(8)]
                      for row in range(64)])
        bm = np.array([[smem[_isa_b_offset(k, col, lbo, sbo)]
                        for col in range(n)] for k in range(8)])
        dmat = a @ bm
        regs_d = {_isa_wg_d(row, col): dmat[row, col]
                  for row in range(64) for col in range(n)}
        # the kernel reads D register i of thread tid as (row, col)
        got = np.full((64, n), np.nan)
        for idx in range(128 * n // 2):
            row, col = wd[2 * idx:2 * idx + 2]
            got[row, col] = regs_d[idx // (n // 2), idx % (n // 2)]
        np.testing.assert_allclose(got, rt.T @ bt.T, rtol=1e-12, atol=1e-12)
        return
    bt = rng.standard_normal((16, 8))    # 16 rows of b
    rt = rng.standard_normal((8, 8))     # 8 columns of r
    regs_a, regs_b = {}, {}
    for lane in range(32):
        for i in range(2):
            for h in range(2):
                row, k = ma[((lane * 2 + i) * 2 + h) * 2:][:2]
                regs_a[lane, i, h] = bt[row, k]
            k, col = mb[(lane * 2 + i) * 2:][:2]
            regs_b[lane, 0, i] = rt[k, col]
    a = np.array([[regs_a[_isa_mma("a", row, k)] for k in range(8)]
                  for row in range(16)])
    bm = np.array([[regs_b[_isa_mma("b", k, col)] for col in range(8)]
                   for k in range(8)])
    dmat = a @ bm
    regs_d = {_isa_mma("d", row, col)[:2]: dmat[row, col]
              for row in range(16) for col in range(8)}
    got = np.full((16, 8), np.nan)
    for lane in range(32):
        for i in range(4):
            row, col = md[(lane * 4 + i) * 2:][:2]
            got[row, col] = regs_d[lane, i]
    np.testing.assert_allclose(got, bt @ rt, rtol=1e-12, atol=1e-12)


def test_wgmma_b_tile_fills_its_buffer(probe_lib):
    """hi's kernel writes b^T's (k, col) to word wg_b_offset / 4 of a
    buffer of 8 R3W_WG_ROWS words (csrc/probes.cu mxu_wg_kernel bsm):
    the offsets are those words, each once, 4-byte aligned, and each
    16-byte row of a core matrix holds four k of one column."""
    n = _defines()["R3W_WG_ROWS"]
    wb = _maps(probe_lib)[2].reshape(8, n)
    assert sorted(wb.ravel().tolist()) == list(range(0, 4 * 8 * n, 4))
    for k in range(8):
        for col in range(n):
            assert wb[k, col] // 16 == wb[k - k % 4, col] // 16
            assert wb[k, col] % 16 == 4 * (k % 4)


def test_probe_wrappers_on_cpu_run_plain_versions():
    perm, box, geom = PR.r3n_tables()
    b, r = PR.r3w_inputs()
    before = dict(kernels.launches)
    assert torch.equal(kernels.rowslice_probe(2, 3, box, geom),
                       PR.rowslice_ref(2, 3, box, geom))
    assert torch.equal(kernels.mxu_probe("hi", b, r, 2),
                       PR.mxu_ref("hi", b, r, 2))
    assert kernels.launches == before


@pytest.mark.parametrize("kind", kernels.MXU_KINDS)
def test_chain_floor_arithmetic(kind):
    """A chain floor is an empty launch plus R3W_REPS runs of one rep's
    path at the links' latencies (here made up) over the clock; each
    kind's path names links that the floor kernels measure."""
    from rene_tpu_torch import probes
    cycles = {"fmul": 2.0, "fadd": 4.0, "minmax": 3.0, "cvt_bf16": 5.0,
              "hmma_bf16": 30.0, "wg_hi": 100.0}
    assert set(cycles) == set(probes.FLOOR_KINDS)
    fl = {"cycles": cycles, "ghz": 2.0, "empty_ms": 0.001}
    per_rep = {"vpu": 32 * (6 * 2.0 + 5 * 4.0 + 3 * 3.0),
               "hi": 100.0, "def": 4.0 + 5.0 + 30.0}[kind]
    path = probes.chain(kind)
    assert set(path) <= set(probes.FLOOR_KINDS)
    assert probes.chain_floor_ms(path, fl) == pytest.approx(
        0.001 + PR.R3W_REPS * per_rep / 2e6)


def test_floor_kinds_in_the_c_order():
    """probes.FLOOR_KINDS[i] is the chain that floor_probe_launch runs
    for kind i (probes.cu FLOOR_<NAME> i), so each latency has its
    link's name."""
    from rene_tpu_torch import probes
    text = (kernels.CSRC / "probes.cu").read_text()
    c_kinds = dict(re.findall(r"#define FLOOR_(\w+) (\d+)", text))
    assert {int(v): k.lower() for k, v in c_kinds.items()} == dict(
        enumerate(probes.FLOOR_KINDS))


def test_floor_wrappers_refuse_cpu():
    """The floor wrappers have no plain version (a latency of the card):
    on CPU tensors they raise."""
    cpu = torch.device("cpu")
    with pytest.raises(ValueError):
        kernels.floor_probe(0, 256, cpu)
    with pytest.raises(ValueError):
        kernels.empty_probe(cpu)


@pytest.mark.cuda
def test_probe_kernels_on_card_match_plain_version():
    """On a CUDA card: P-r3n bit for bit for its three modes and the
    script's groups; P-r3w's hi and def within 1e-5 of |B| |R| of
    their plain versions at 200 reps, vpu bit for bit; each kind's time
    at 200 reps over its time at 100, each less its time at one rep, at
    least 1.6; M4 within one pair of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    from rene_tpu_torch import probes
    dev = torch.device("cuda", 0)
    before = dict(kernels.launches)
    n = probes.r3n(dev)
    w = probes.r3w(dev)
    assert all(ok for ok, _ in n.values()), n
    assert all(w[k]["ok"] for k in kernels.MXU_KINDS), \
        {k: w[k]["err"] for k in kernels.MXU_KINDS}
    assert all(w[k]["ratio"] >= probes.RATIO_MIN
               for k in kernels.MXU_KINDS)
    assert probes.m4_agrees(w["m4"])
    assert kernels.launches["rowslice_probe"] > before["rowslice_probe"]
    for k in kernels.MXU_KINDS:
        assert kernels.launches["mxu_probe_" + k] \
            > before["mxu_probe_" + k]
