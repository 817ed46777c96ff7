"""Frozen copy of the port's plain versions (rene_tpu_torch at commit
ed2dcef): the pbrt frontend, the table packing and BVH builds, the plain
path and volpath lanes. See port_bench/reference."""
