"""rene_tpu_torch: the PyTorch/CUDA port of rene-tpu for NVIDIA Hopper.

The JAX package `rene_tpu` is the reference. This package reuses its
numpy-only host frontend (pbrt parser, scene flattening, device buffers,
film encoders) and replaces everything that runs on the accelerator:

    pbrt scene -> rene_tpu.scene.build_device_scene (numpy buffers)
      -> scene.pack: flat float32 tables for the kernel
      -> integrators.mega_path: one CUDA megakernel launch per chunk
         (csrc/mega_path.cu), or its plain PyTorch version on the CPU
      -> render.render: chunk loop, film average, y-flip
      -> cli: PNG + normal/albedo AOVs

Nothing here imports jax. Every function that runs on tensors takes an
explicit `device`; there is no global default device.
"""

__version__ = "0.1.0"
