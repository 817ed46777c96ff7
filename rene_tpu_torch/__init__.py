"""rene_tpu_torch: the PyTorch/CUDA port of rene-tpu for NVIDIA Hopper.

The JAX package `rene_tpu` is the reference. This package keeps its own
copy of the numpy-only host frontend (pbrt parser, scene flattening,
device buffers, the BVH builder, film encoders) and replaces everything
that runs on the accelerator:

    pbrt scene -> scene.build_device_scene (numpy buffers)
      -> scene.pack: flat float32 tables for the kernels
      -> engine "pallas": integrators.mega_path, one CUDA megakernel
         launch per chunk (csrc/mega_path.cu), whose path body or volpath
         body (integrators.volpath: homogeneous media, transmittance
         marching, medium interfaces) the scene's integrator picks
         engine "wave": integrators.wave, waves of lanes advanced a few
         bounces per launch and regrouped between launches (csrc/wave.cu)
         (on the CPU, the kernels' plain PyTorch versions)
      -> render.render: chunk loop, film average, y-flip
      -> cli: PNG + normal/albedo AOVs

Nothing here imports jax or rene_tpu. Every function that runs on tensors
takes an explicit `device`; there is no global default device.
"""

__version__ = "0.1.0"
