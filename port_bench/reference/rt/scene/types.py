"""Frozen copy of rene_tpu_torch/scene/types.py at commit ed2dcef.

Shared enum tags for the flat SoA scene representation.

The reference encodes every polymorphic GPU type as a C-style tagged union
(`Enum*` = u32 tag + fixed UVec4/Vec4 payload). We keep the same
layout idea — a tag array plus generic `u0`/`u1` int and `v0` float payload
lanes — because it maps directly onto masked vectorized evaluation on TPU.

Tag values follow the reference enum declaration order so scene dumps are
directly comparable (material.rs:54-63, texture.rs:24-30, medium.rs:49-52,
area_light.rs:8-12).
"""

# materials (reference material.rs MaterialType)
MAT_NONE = 0
MAT_MATTE = 1
MAT_GLASS = 2
MAT_SUBSTRATE = 3
MAT_METAL = 4
MAT_MIRROR = 5
MAT_UBER = 6
MAT_PLASTIC = 7

# textures (reference texture.rs TextureType)
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGEMAP = 2
TEX_SCALE = 3

# media (reference medium.rs MediumType)
MEDIUM_VACUUM = 0
MEDIUM_HOMOGENEOUS = 1

# area lights (reference area_light.rs AreaLightType)
AREA_NULL = 0
AREA_DIFFUSE = 1

# instance geometry kind (reference ShaderOffset, main.rs:41-45)
KIND_TRIANGLE = 0
KIND_SPHERE = 1

# BxDF lobe types (reference reflection.rs BxdfType)
BXDF_LAMBERTIAN = 0
BXDF_FRESNEL_SPECULAR = 1
BXDF_FRESNEL_BLEND = 2
BXDF_MICROFACET_REFLECTION = 3
BXDF_SPECULAR_REFLECTION = 4
BXDF_SPECULAR_TRANSMISSION = 5

# Fresnel variants (reference fresnel.rs FresnelType)
FRESNEL_CONDUCTOR = 0
FRESNEL_NOOP = 1
FRESNEL_DIELECTRIC = 2

# BxDF kind bitflags (reference reflection.rs:66-74)
KIND_REFLECTION = 1 << 0
KIND_TRANSMISSION = 1 << 1
KIND_DIFFUSE = 1 << 2

BSDF_MAX_LOBES = 5  # reference BXDF_LEN, reflection.rs:228
