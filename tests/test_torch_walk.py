"""The mesh walk (K1c, K1d: csrc/bvh.cuh through csrc/intersect.cuh),
checked on the CPU.

* Its g++ build (csrc/cast_launch.cuh, the ray-cast probe every mesh
  build holds) against the plain walk (ops/intersect.py `cast_ref` over
  ops/bvh.py's binary walk) on rays the plain version records
  (`intersect.ray_log`) while it traces the three small mesh scenes and
  the small fog mesh: t bit for bit, the same part and row, the same
  hit and any-hit flags, on every ray.
* Exact ties in t: a triangle twice in two leaves, and two instances on
  one spot; the lowest part and row win in the g++ build and in plain,
  whatever order the lanes or the walk take.
* The collapse into wide nodes (scene/accel.py `wide_tables`): every
  triangle reachable once, every child box inside its parent's, the
  stack bound, rows in place.
* The counting build and the probe's wrapper: CPU tables take the plain
  version; on a card (`cuda`) they count.
"""
import ctypes

import numpy as np
import pytest
import torch

from rene_tpu.pbrt import parse_pbrt
from rene_tpu.scene import create_scene
from rene_tpu.scene.device import build_device_scene
from rene_tpu_torch import kernels, scenes
from rene_tpu_torch.integrators import mega_path as M
from rene_tpu_torch.integrators import volpath as V
from rene_tpu_torch.ops import intersect as X
from rene_tpu_torch.scene import accel as A
from rene_tpu_torch.scene import pack as P
from .test_torch_mesh import buffers as mesh_buffers

torch.set_num_threads(2)

CAST_HARNESS = r"""
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
#pragma GCC diagnostic ignored "-Wunused-function"
#include "cast_launch.cuh"
// the rays one after another, in the order `order` gives (all rows of
// `rays` are cast; out row i is ray i's)
static const int* g_order = nullptr;
extern "C" void set_order(const int* order) { g_order = order; }
static int run_casts(const Scene& s, const float* rays, int n, float* out,
                     void*) {
  for (int j = 0; j < n; ++j) {
    const int i = g_order ? g_order[j] : j;
    cast_ray(s, rays + (size_t)i * RAY_W, out + (size_t)i * CAST_OUT_W);
  }
  return 0;
}
"""

# the scenes whose rays the tests record: the three small mesh scenes
# (tests/test_torch_mesh.py) and the small fog mesh
SCENES = ("mesh_materials", "instanced", "sphere_table", "fog_mesh")
RECORD_DEPTH = 4


@pytest.fixture(scope="module")
def cast_lib(tmp_path_factory):
    from .test_torch_kernel_source import _gxx
    lib = _gxx(tmp_path_factory, "cast_walk", CAST_HARNESS)
    lib.cast_probe_launch.argtypes = kernels.CAST_ARGTYPES
    lib.cast_probe_launch.restype = ctypes.c_int
    lib.set_order.argtypes = [ctypes.c_void_p]
    return lib


def _tables(name):
    if name == "fog_mesh":
        src = scenes.fog_mesh_scene(32, 16, maxdepth=RECORD_DEPTH,
                                    small=True)
        bn, cfg = build_device_scene(create_scene(parse_pbrt(src), "/tmp"))
    else:
        bn, cfg = mesh_buffers(name, 32, 16)
    return M.device_tables(P.pack_tables(bn, cfg), "cpu")


def record_rays(tabs, seed=5):
    """The rays of every cast of the plain version's 1-spp run at
    maxdepth RECORD_DEPTH (camera rays, bounces, shadow rays; volpath
    march segments), as (n, RAY_W) rows."""
    X.ray_log = []
    try:
        tabs = dict(tabs, max_depth=RECORD_DEPTH)
        (V.vol_lanes_ref if tabs["volpath"] else M.path_lanes_ref)(
            tabs, seed, 1)
        return torch.cat(X.ray_log)
    finally:
        X.ray_log = None


def cast_gxx(lib, tabs, rays, order=None):
    out = torch.empty((rays.shape[0], kernels.CAST_OUT_W))
    keep = None
    if order is not None:
        keep = np.ascontiguousarray(order, np.int32)
        lib.set_order(keep.ctypes.data)
    try:
        rc = lib.cast_probe_launch(*kernels.cast_args(tabs, rays, out), None)
    finally:
        lib.set_order(None)
    assert rc == 0
    return out


def _same(out, ref, rays):
    """Every ray's result bit for bit: t, part, row and flag of a closest
    ray, the any-hit flag of a shadow ray."""
    closest = rays[:, 8] == X.CAST_CLOSEST
    a, b = out[closest], ref[closest]
    assert torch.equal(a[:, 0].view(torch.int32), b[:, 0].view(torch.int32))
    assert torch.equal(a[:, 1:], b[:, 1:])
    assert torch.equal(out[~closest, 3], ref[~closest, 3])


@pytest.mark.parametrize("name", SCENES)
def test_walk_matches_plain_walk_on_recorded_rays(cast_lib, name):
    tabs = _tables(name)
    rays = record_rays(tabs)
    kinds = rays[:, 8]
    assert (kinds == X.CAST_CLOSEST).sum() > 500
    if name != "fog_mesh":
        assert (kinds == X.CAST_SHADOW).sum() > 100
    ref = X.cast_ref(tabs, rays)
    hits = ref[kinds == X.CAST_CLOSEST, 1]
    # the recorded rays reach the mesh and the table parts
    assert bool((hits >= 1).any())
    _same(cast_gxx(cast_lib, tabs, rays), ref, rays)
    # the wrapper's CPU side is the plain version
    assert torch.equal(kernels.cast_probe(tabs, rays), ref)


# -- exact ties ---------------------------------------------------------------
TRI = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])


def _rows(tris):
    """Mesh rows (scene/accel.py layout) of (T, 3, 3) triangles, material
    slot 0, the geometric normal as shading normal."""
    tris = np.asarray(tris, np.float64)
    rows = np.zeros((tris.shape[0], A.MESH_W), np.float32)
    rows[:, A.MESH_V0:A.MESH_V0 + 3] = tris[:, 0]
    rows[:, A.MESH_E1:A.MESH_E1 + 3] = tris[:, 1] - tris[:, 0]
    rows[:, A.MESH_E2:A.MESH_E2 + 3] = tris[:, 2] - tris[:, 0]
    rows[:, A.MESH_N0:A.MESH_N0 + 3] = np.cross(tris[:, 1] - tris[:, 0],
                                                tris[:, 2] - tris[:, 0])
    return rows


def _node(lo, hi, a, b):
    row = np.zeros(A.NODE_W, np.float32)
    row[A.NODE_LO:A.NODE_LO + 3], row[A.NODE_HI:A.NODE_HI + 3] = lo, hi
    row[A.NODE_A], row[A.NODE_B] = a, b
    return row


def _with_mesh(nodes, mesh, world_root, insts=None):
    """The small mesh scene's tables (its immediates, materials, camera
    and lights) with the acceleration tables replaced: binary `nodes`,
    `mesh` rows, the world root and instance rows (INST_W)."""
    tabs = _tables("mesh_materials")
    insts = np.zeros((0, A.INST_W), np.float32) if insts is None else insts
    insts = np.array(insts, np.float32)
    sph_box = np.zeros((0, A.BOX_W), np.float32)
    wt = A.wide_tables(nodes, mesh, world_root, insts, sph_box)
    f = torch.from_numpy
    return dict(tabs, nodes=f(nodes), mesh=f(mesh), mesh_vt=f(wt["mesh_vt"]),
                wnodes=f(wt["wnodes"]), top=wt["top"], world_root=world_root,
                insts=f(insts), insts_f=insts.tolist(),
                mesh_uv=torch.zeros((0, A.MESH_UV_W)),
                sph_tab=torch.zeros((0, A.SPHT_W)), sph_box=f(sph_box),
                bvh_depth=4, has_accel=True)


def _tie_rays(n=256, seed=3):
    """Closest rays at the triangle TRI from above and from below, and
    shadow rays along them."""
    g = np.random.default_rng(seed)
    uv = g.uniform(0.05, 0.4, (n, 2))
    up = np.arange(n) % 2 == 0
    o = np.stack([uv[:, 0], uv[:, 1], np.where(up, 3.0, -3.0)], 1)
    d = np.stack([g.normal(0, 1e-3, n), g.normal(0, 1e-3, n),
                  np.where(up, -1.0, 1.0)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.zeros((2 * n, X.RAY_W), np.float32)
    rays[:, 0:3], rays[:, 3:6] = np.tile(o, (2, 1)), np.tile(d, (2, 1))
    rays[:, 6], rays[:, 7] = X.TMIN, 10.0
    rays[n:, 8] = X.CAST_SHADOW
    return torch.from_numpy(rays)


def _check_ties(cast_lib, tabs, part):
    """Every ray hits TRI at its equal t in part `part`, row 0, in the g++
    build in the rays' order and in reverse, and in plain."""
    rays = _tie_rays()
    closest = rays[:, 8] == X.CAST_CLOSEST
    ref = X.cast_ref(tabs, rays)
    assert bool((ref[closest, 1] == part).all()), ref[closest, 1].unique()
    assert bool((ref[closest, 2] == 0).all())
    assert bool((ref[~closest, 3] == 1).all())
    n = rays.shape[0]
    for order in (None, np.arange(n)[::-1]):
        _same(cast_gxx(cast_lib, tabs, rays, order), ref, rays)


def test_tie_same_triangle_in_two_leaves(cast_lib):
    """TRI at rows 0 and 4, in two leaves whose boxes a ray from above
    enters in one order and a ray from below in the other: row 0 wins."""
    far = [[[5.0 + k, 0.0, z], [5.5 + k, 0.0, z], [5.0 + k, 0.5, z]]
           for k, z in ((0, 1.0), (1, 1.0), (2, 1.0))]
    near = [[[-5.0 - k, 0.0, z], [-4.5 - k, 0.0, z], [-5.0 - k, 0.5, z]]
            for k, z in ((0, -1.0), (1, -1.0), (2, -1.0))]
    mesh = _rows([TRI] + far + [TRI] + near)
    lo_l, hi_l = (0.0, 0.0, 0.0), (7.5, 1.0, 1.0)
    lo_r, hi_r = (-7.0, 0.0, -1.0), (1.0, 1.0, 0.0)
    nodes = np.stack([_node((-7.0, 0.0, -1.0), (7.5, 1.0, 1.0), 1, 2),
                      _node(lo_l, hi_l, 0, -4), _node(lo_r, hi_r, 4, -4)])
    _check_ties(cast_lib, _with_mesh(nodes, mesh, 0), PART_WORLD)


PART_WORLD, PART_INST = 1, 2


def _blas(tris, offset):
    """A one-leaf binary BVH over `tris`, its rows from `offset`."""
    t = np.asarray(tris, np.float64)
    return _node(t.min((0, 1)), t.max((0, 1)), offset, -t.shape[0])


def test_tie_overlapping_instances(cast_lib):
    """Two instances of one BLAS on the same spot, listed after a third
    elsewhere: the lowest instance row on the spot wins; with the world
    mesh holding the same triangle, the world wins."""
    away = np.eye(3, 4, dtype=np.float32)
    away[:, 3] = (0.0, 40.0, 0.0)

    def inst(w2o, mat):
        row = np.zeros(A.INST_W, np.float32)
        row[A.INST_W2O:A.INST_W2O + 12] = w2o.reshape(-1)
        row[A.INST_MAT] = mat
        return row

    here = np.eye(3, 4, dtype=np.float32)
    blas = _blas([TRI, TRI + [0.0, 0.0, 0.5]], 0)
    mesh = _rows([TRI, TRI + [0.0, 0.0, 0.5]])
    insts = []
    for w2o, mat in ((away, 1), (here, 2), (here, 3)):
        row = inst(w2o, mat)
        row[A.INST_ROOT] = 0
        insts.append(row)
    tabs = _with_mesh(blas[None], mesh, -1, insts)
    # the rays from below meet z = 0 first, those from above z = 0.5
    rays = _tie_rays()
    ref = X.cast_ref(tabs, rays)
    closest = rays[:, 8] == X.CAST_CLOSEST
    assert bool((ref[closest, 1] == PART_INST + 1).all())
    _same(cast_gxx(cast_lib, tabs, rays), ref, rays)
    _same(cast_gxx(cast_lib, tabs, rays, np.arange(rays.shape[0])[::-1]),
          ref, rays)
    # the same triangles in the world mesh too: the world part wins
    nodes = np.stack([_blas([TRI, TRI + [0.0, 0.0, 0.5]], 0),
                      _blas([TRI, TRI + [0.0, 0.0, 0.5]], 2)])
    mesh = _rows([TRI, TRI + [0.0, 0.0, 0.5]] * 2)
    for row in insts:
        row[A.INST_ROOT] = 1
    tabs = _with_mesh(nodes, mesh, 0, insts)
    ref = X.cast_ref(tabs, rays)
    assert bool((ref[closest, 1] == PART_WORLD).all())
    _same(cast_gxx(cast_lib, tabs, rays), ref, rays)


# -- the collapse -------------------------------------------------------------
def _binary_leaves(nodes, root):
    out, todo = [], [root]
    while todo:
        n = todo.pop()
        if nodes[n, A.NODE_B] < 0:
            out.append((int(nodes[n, A.NODE_A]), int(-nodes[n, A.NODE_B])))
        else:
            todo += [int(nodes[n, A.NODE_A]), int(nodes[n, A.NODE_B])]
    return out


def _collapse_check(nodes, mesh, root):
    """Collapse the binary BVH at `root`: its leaves reached once each,
    the same rows; every child's float32 box inside the box of the slot
    that leads to it; every quantized box holding its float32 box and
    the triangles below it."""
    wide = A._Wide()
    top = A._collapse(wide, nodes, root)
    dec = A.decode_boxes(wide.rows())
    tri = mesh[:, A.MESH_V0:A.MESH_V0 + 3, None] + np.stack(
        [np.zeros((mesh.shape[0], 3)), mesh[:, A.MESH_E1:A.MESH_E1 + 3],
         mesh[:, A.MESH_E2:A.MESH_E2 + 3]], 2)
    tri_lo, tri_hi = tri.min(2), tri.max(2)
    leaves = []

    def walk(w, slot_box):
        rows = []
        for c, e in enumerate(wide.ents[w]):
            box = wide.boxes[w][c]
            if slot_box is not None:
                assert (box[:3] >= slot_box[:3]).all()
                assert (box[3:] <= slot_box[3:]).all()
            assert (dec[w, c, :3] <= box[:3]).all()
            assert (dec[w, c, 3:] >= box[3:]).all()
            tag, pay = e >> A.TAG_SHIFT, e & A.TAG_PAYLOAD
            if tag == A.TAG_NODE:
                below = walk(pay, box)
            else:
                assert tag == A.TAG_LEAF
                start = pay >> A.LEAF_COUNT_BITS
                count = pay & ((1 << A.LEAF_COUNT_BITS) - 1)
                leaves.append((start, count))
                below = list(range(start, start + count))
            assert (tri_lo[below] >= dec[w, c, :3] - 1e-6).all()
            assert (tri_hi[below] <= dec[w, c, 3:] + 1e-6).all()
            rows += below
        return rows

    rows = walk(top, None)
    assert sorted(leaves) == sorted(_binary_leaves(nodes, root))
    assert sorted(rows) == sorted(set(rows))
    return rows


@pytest.mark.parametrize("name", ["mesh_materials", "instanced", "random"])
def test_collapse_keeps_every_triangle_once(name):
    if name == "random":
        from .test_torch_mesh import _random_mesh
        b = A._Builder()
        b.add(_random_mesh(5000, 7), np.zeros((5000, 3, 3)), np.zeros(5000))
        nodes = np.concatenate(b.nodes).astype(np.float32)
        mesh = np.concatenate(b.rows).astype(np.float32)
        roots = [0]
        need = A.wide_tables(nodes, mesh, 0, np.zeros((0, A.INST_W),
                                                       np.float32),
                             np.zeros((0, A.BOX_W), np.float32))["walk_need"]
    else:
        t = P.pack_tables(*mesh_buffers(name, 32, 16))
        nodes, mesh, need = t.nodes, t.mesh, t.walk_need
        roots = sorted({int(r) for r in t.insts[:, A.INST_ROOT]}
                       | ({t.world_root} if t.world_root >= 0 else set()))
        np.testing.assert_array_equal(t.mesh_vt[:, :9], mesh[:, :9])
        assert not t.mesh_vt[:, 9:].any()
    covered = []
    for root in roots:
        covered += _collapse_check(nodes, mesh, root)
    # every mesh row under exactly one BVH, rows in place
    assert sorted(covered) == list(range(mesh.shape[0]))
    assert 0 < need <= A.TRAVERSAL_STACK


def test_instance_box_holds_its_blas():
    """An instance's world box holds the object box's corners under the
    instance's transform, rounded outward."""
    w2o = np.array([[0.0, 2.0, 0.0, 1.0], [-2.0, 0.0, 0.0, 0.5],
                    [0.0, 0.0, 2.0, -3.0]], np.float32)
    box = np.array([-1.0, -1.0, -1.0, 0.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    wb = A._instance_box(w2o, box[[0, 1, 2, 4, 5, 6]])
    m = np.linalg.inv(np.vstack([w2o, [0, 0, 0, 1]]).astype(np.float64))
    corners = np.array([[x, y, z, 1.0] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)]) @ m.T
    assert (wb[:3] < corners[:, :3].min(0)).all()
    assert (wb[3:] > corners[:, :3].max(0)).all()


# -- the counting build and the probe's wrapper -------------------------------
def test_counting_takes_card_tables_only():
    tabs = _tables("instanced")
    with pytest.raises(ValueError):
        kernels.mega_path_walk_counts(tabs, 1, 1)
    with pytest.raises(ValueError):
        kernels.cast_probe(tabs, torch.zeros((4, kernels.RAY_W)),
                           counting=True)


@pytest.mark.cuda
def test_counting_build_counts_on_card():
    """On a card: the counting build's walk counts over a launch and over
    the probe's rays, and the probe against the plain walk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    tabs = M.device_tables(P.pack_tables(*mesh_buffers("instanced")), "cuda")
    out, c = kernels.mega_path_walk_counts(tabs, 7, 1)
    assert c["closest"]["casts"] > 0 and c["closest"]["nodes"] > 0
    assert 0 < c["closest"]["active_lanes"] <= 32 * c["closest"]["warp_steps"]
    assert 0 < c["closest"]["deepest_stack"] <= A.TRAVERSAL_STACK
    rays = record_rays(_tables("instanced")).cuda()
    before = kernels.launches["cast_probe"]
    res = kernels.cast_probe(tabs, rays)
    assert kernels.launches["cast_probe"] == before + 1
    ref = X.cast_ref(tabs, rays)
    same = (res[:, 1:] == ref[:, 1:]).all(1).double().mean()
    assert same >= 0.999, same
    _, cc = kernels.cast_probe(tabs, rays, counting=True)
    assert cc["closest"]["casts"] == int((rays[:, 8] == 0).sum())
