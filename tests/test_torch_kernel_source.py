"""The CUDA kernel's source, checked on the CPU.

csrc/*.cuh hold the per-lane code of csrc/mega_path.cu as plain C++ with
CUDA qualifiers. Compiled here with g++ (qualifiers mapped away, `__ldg`,
`rsqrtf` and `__uint_as_float` given their C meaning) behind the same C
entry point, it runs the kernel's arithmetic without a card and without
FMA contraction, so it must agree with the plain PyTorch version lane for
lane: by the per-pixel rule of rene_tpu_torch.checks, >= 99.5% of
pixels' radiance and of their normal/albedo sums agree, image means
within 1e-4 relative, equal ray counts. The remaining lanes differ by libm against torch's vectorized
sin/cos/log. The wrapper's argument checks run here too.
"""
import ctypes
import shutil
import subprocess

import pytest
import torch

from rene_tpu_torch import checks, kernels
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.scene import pack as P
from .test_torch_mega_path import _buffers
from .test_torch_mesh import buffers as mesh_buffers

torch.set_num_threads(2)


HARNESS = r"""
#include <cmath>
#include <cstring>
#include <cstdint>
#include <cstddef>
#define __device__
#define __forceinline__ inline
#define __ldg(p) (*(p))
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
static inline float __uint_as_float(uint32_t u) {
  float f; memcpy(&f, &u, 4); return f;
}
#include "path.cuh"
// the lanes run one after another
static int run_lanes(const Params& p, void*) {
  for (int lane = 0; lane < p.n_pix; ++lane) {
    if (p.has_accel) trace_lane<true>(p, lane);
    else trace_lane<false>(p, lane);
  }
  return 0;
}
#include "launch.cuh"
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the kernel's per-lane code for the CPU")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "harness.cpp").write_text(HARNESS)
    so = d / "libhost.so"
    res = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall",
         "-Wno-unknown-pragmas", "-Werror", f"-I{kernels.CSRC}", "-o",
         str(so), str(d / "harness.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(so))
    lib.mega_path_launch.argtypes = kernels.ARGTYPES
    lib.mega_path_launch.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize("name,beckmann", [
    ("cornell_box", False), ("materials_scene", False),
    ("materials_scene", True), ("lights_only", False)],
    ids=["cornell", "materials", "beckmann", "lights_only"])
def test_cuda_lane_code_matches_plain_version(host_lib, name, beckmann):
    bn, cfg = _buffers(name)
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, beckmann, out)
    assert host_lib.mega_path_launch(*args, None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp, beckmann=beckmann).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()


@pytest.mark.parametrize("name", ["mesh_materials", "instanced",
                                  "sphere_table"])
def test_cuda_mesh_lane_code_matches_plain_version(host_lib, name):
    """The mesh variant (trace_lane<true>: BVH walk, instances, sphere
    table, 32x32-block seeds) against the plain version."""
    tabs = M.device_tables(P.pack_tables(*mesh_buffers(name)), "cpu")
    assert tabs["has_accel"]
    seed, spp = 99, 4
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    args = kernels.launch_args(tabs, seed, spp, False, out)
    assert host_lib.mega_path_launch(*args, None) == 0
    ref = M.path_lanes_ref(tabs, seed, spp).numpy()
    out = out.numpy()
    a = checks.agreement(out, ref)
    assert a["rad_frac"] >= 0.995, a
    assert a["aov_frac"] >= 0.995, a
    assert a["mean_rel"] <= 1e-4, a
    assert out[9].sum() == ref[9].sum()


def test_launch_args_check_tables():
    bn, cfg = _buffers("cornell_box")
    tabs = M.device_tables(P.pack_tables(bn, cfg), "cpu")
    out = torch.empty((P.OUT_ROWS, 128 * 64), dtype=torch.float32)
    bad = dict(tabs, tris=tabs["tris"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="tris: shape"):
        kernels.launch_args(bad, 0, 1, False, out)
    bad = dict(tabs, tris=tabs["tris"].t().contiguous().t())
    with pytest.raises(ValueError, match="tris: not contiguous"):
        kernels.launch_args(bad, 0, 1, False, out)
    bad = dict(tabs, emit_tris=tabs["emit_tris"].long())
    with pytest.raises(ValueError, match="emit_tris: dtype"):
        kernels.launch_args(bad, 0, 1, False, out)
    with pytest.raises(ValueError, match="out: shape"):
        kernels.launch_args(tabs, 0, 1, False, out[:, :10].contiguous())
    # CPU tables run the plain version and count no launch
    before = dict(kernels.launches)
    torch.testing.assert_close(kernels.mega_path(tabs, 3, 1),
                               M.path_lanes_ref(tabs, 3, 1), rtol=0, atol=0)
    assert kernels.launches == before
    meta = dict(tabs, tris=tabs["tris"].to("meta"))
    with pytest.raises(ValueError, match="needs CUDA or CPU tensors"):
        kernels.mega_path(meta, 0, 1)
