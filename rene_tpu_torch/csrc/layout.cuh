// Row layouts of the scene tables the path megakernel reads.
// Written by rene_tpu_torch/scene/pack.py; tests/test_torch_frontend.py
// holds every value here equal to its constant there.
#pragma once

// triangles: Plücker moments/edges, plane, shading normals, sampling data
#define TRI_M0 0
#define TRI_E0 3
#define TRI_M1 6
#define TRI_E1 9
#define TRI_M2 12
#define TRI_E2 15
#define TRI_PN 18
#define TRI_PK 21
#define TRI_N0 22
#define TRI_N1 25
#define TRI_N2 28
#define TRI_AREA 31
#define TRI_GN 32
#define TRI_PRIMS 35
#define TRI_EMIT 36
#define TRI_MAT 39
#define TRI_V0 40
#define TRI_V1 43
#define TRI_V2 46
#define TRI_UV0 49
#define TRI_UV1 51
#define TRI_UV2 53
#define TRI_W 55
// the immediates' cast rows (scene/pack.py imm_rows), which the kernels
// copy into shared memory: per triangle the plane (pn, pk) and the
// Plücker moment and edge of each side in six float4, then per sphere its
// world-to-object matrix in three float4
#define IMM_PN 0
#define IMM_PK 3
#define IMM_M0 4
#define IMM_E0 7
#define IMM_M1 10
#define IMM_E1 13
#define IMM_M2 16
#define IMM_E2 19
#define IMM_TRI_W 24
#define IMM_SPH_W 12

// spheres: 3x4 row-major world-to-object and object-to-world matrices
#define SPH_W2O 0
#define SPH_O2W 12
#define SPH_EMIT 24
#define SPH_MAT 27
#define SPH_R2 28
#define SPH_W 29

// material records
#define MAT_TYPE 0
#define MAT_ALBEDO 1
#define MAT_ETA 4
#define MAT_K 7
#define MAT_ALPHA 10
#define MAT_IR 12
#define MAT_OP 13
#define MAT_KR2 16
#define MAT_KT2 19
#define MAT_FSCALE 22
// textured slots: the count of classes that are not solid, the per-hit
// roughness remap flag, then one TEXD_W-wide descriptor per class (kd, ks,
// ru, rv, op, kr, kt): its kind and (uscale, vscale, even rgb, odd rgb) of
// a checker or (texel offset, w, h, same image as the previous image
// class) of an image
#define MAT_NTEX 25
#define MAT_RRM 26
#define MAT_TEX 27
#define TEXD_KIND 0
#define TEXD_US 1
#define TEXD_VS 2
#define TEXD_EVEN 3
#define TEXD_ODD 6
#define TEXD_OFF 1
#define TEXD_IW 2
#define TEXD_IH 3
#define TEXD_SAME 4
#define TEXD_W 9
#define TEXK_SOLID 0
#define TEXK_CHECKER 1
#define TEXK_IMAGE 2
#define N_TEX_CLASSES 7
// a row is a material slot: the material and the media on its two sides
// (interior, exterior; 0 is vacuum), read by the volpath body only
#define MAT_IMED 90
#define MAT_EMED 91
#define MAT_W 92

// homogeneous media: sigma_t rgb, sigma_s rgb, Henyey-Greenstein g, 1 for
// vacuum; row 0 is vacuum
#define MED_ST 0
#define MED_SS 3
#define MED_G 6
#define MED_VAC 7
#define MED_W 8

// emit objects (light sampling records)
#define EO_KIND 0
#define EO_START 1
#define EO_COUNT 2
#define EO_CENTER 3
#define EO_R2 6
#define EO_W 7

// distant lights
#define LIGHT_DIR 0
#define LIGHT_COLOR 3
#define LIGHT_W 6

// camera and film constants
#define CAM_PINV 0
#define CAM_C2W 12
#define CAM_ORIGIN 24
#define CAM_INV_W1 27
#define CAM_INV_H1 28
#define CAM_FILTER 29
#define CAM_BG 30
// the background: its kind, the env image (texel offset, w, h), the
// checker (uscale, vscale, even rgb, odd rgb), the 3x3 background matrix
// and its inverse, row-major
#define CAM_BG_KIND 33
#define CAM_BG_IMG 34
#define CAM_BG_CHK 37
#define CAM_BG_MAT 45
#define CAM_BG_INV 54
#define CAM_W 63
#define BG_CONST 0
#define BG_IMAGE 1
#define BG_CHECKER 2
// the env-map sampling grid (scene/device.py) and the entries of each
// cdf's guide table (scene/pack.py env_guides)
#define ENV_GH 64
#define ENV_GW 128
#define ENV_GUIDE 256

// material types (rene_tpu/scene/types.py)
#define MAT_NONE 0
#define MAT_MATTE 1
#define MAT_GLASS 2
#define MAT_SUBSTRATE 3
#define MAT_METAL 4
#define MAT_MIRROR 5
#define MAT_UBER 6
#define MAT_PLASTIC 7

// emit object kinds
#define KIND_TRIANGLE 0
#define KIND_SPHERE 1

#define RR_START 12
#define OUT_ROWS 10

// acceleration tables (rene_tpu_torch/scene/accel.py)
// binary BVH node, which the plain walk reads and the kernel's wide nodes
// are collapsed from: (min xyz, left child or first triangle),
// (max xyz, right child, or minus the triangle count of a leaf)
#define NODE_LO 0
#define NODE_A 3
#define NODE_HI 4
#define NODE_B 7
#define NODE_W 8
// mesh triangle: v0, e1 = v1 - v0, e2 = v2 - v0, shading normal n0 and its
// deltas d1 = n1 - n0, d2 = n2 - n0, material slot
#define MESH_V0 0
#define MESH_E1 3
#define MESH_E2 6
#define MESH_N0 9
#define MESH_D1 12
#define MESH_D2 15
#define MESH_MAT 18
#define MESH_W 20
// uv of mesh row k, in row k of the side table mesh_uv: uv0, uv1 - uv0,
// uv2 - uv0
#define MESH_UV_W 6
// shared-BLAS instance: 3x4 row-major world-to-object affine, material
// slot, root node of its BLAS
#define INST_W2O 0
#define INST_MAT 12
#define INST_ROOT 13
#define INST_W 16
// table sphere: centre, radius (-1 in padding slots), material slot; and
// the box of each SPH_BLOCK-slot block
#define SPHT_C 0
#define SPHT_R 3
#define SPHT_MAT 4
#define SPHT_W 8
#define BOX_LO 0
#define BOX_HI 4
#define BOX_W 8
#define SPH_BLOCK 128
// the walk's tables (scene/accel.py wide_tables). A wide node: per child
// box coordinate one float4 over the BVH_WIDTH children (lo x, hi x, lo y,
// hi y, lo z, hi z), then the children's walk entries (int32 bits; -1 for
// an unused slot) and four unused floats
#define BVH_WIDTH 4
#define NODE4_LX 0
#define NODE4_HX 4
#define NODE4_LY 8
#define NODE4_HY 12
#define NODE4_LZ 16
#define NODE4_HZ 20
#define NODE4_REF 24
#define NODE4_W 32
// mesh_vt rows: v0, e1, e2 of mesh row k, then three zeros
#define VT_W 12
// the wide root of an instance's BLAS, in its instance row
#define INST_WROOT 14
// a walk entry: tag << TAG_SHIFT | payload; a leaf's payload is its
// first mesh row << LEAF_COUNT_BITS | its triangles
#define TAG_SHIFT 29
#define TAG_NODE 0
#define TAG_LEAF 1
#define TAG_INST 2
#define TAG_BLOCK 3
#define LEAF_COUNT_BITS 4
#define TAG_PAYLOAD 536870911
#define TAG_MARKER 1610612735
#define TAG_EMPTY -1
// entries of a thread's walk stack
#define TRAVERSAL_STACK 64

// the wave engine's state rows (rene_tpu_torch/integrators/wave.py): one
// (W_NROWS, n_pad) float32 array, row r of lane l at r * n_pad + l
#define WROW_O 0
#define WROW_D 3
#define WROW_C 6
#define WROW_R 9
#define WROW_ALIVE 12
#define WROW_RAYS 13
#define WROW_LANE 14
#define WROW_PX 15
#define WROW_PY 16
#define WROW_SMP 17
#define WROW_DEP 18
#define WROW_WANT 19
#define WROW_KEY 20
#define W_SORT_ROWS 21
// volpath waves: the lane's medium, moved by every sort with the rows
// before it
#define WROW_MED 21
#define W_SORT_PAD 24
#define WROW_AN 24
#define WROW_AA 27
#define W_NROWS 32
#define W_SLICE 128
#define W_TILE 1024
// sort keys: 0x3F000000 for a parked lane, 0x40000000 or'd into every key
#define W_KEY_DEAD 1056964608
#define W_KEY_BIT 1073741824
#define DEAD_ORIGIN 1e30f
