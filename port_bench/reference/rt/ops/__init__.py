"""Frozen copy of rene_tpu_torch/ops/__init__.py at commit ed2dcef.

Per-lane device math of the path megakernel, as plain PyTorch.

Each function mirrors a closure of rene_tpu/integrators/pallas_path.py
`_build_kernel` and runs over (N,) lane tensors. They make up the plain
version of the CUDA kernel (`integrators.mega_path.path_lanes_ref`).
"""
