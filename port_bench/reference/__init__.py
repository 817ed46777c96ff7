"""The benchmark's plain reference: what a render of a scene should give.

`rt/` is a frozen copy of the port's plain versions (the pbrt frontend,
the table packing and BVH builds, the plain path and volpath lanes),
taken from rene_tpu_torch at commit ed2dcef; each file names
its origin in its header. `render.py` drives it as the port's chunk loop
drives the megakernel, over a sample of pixels; `bounds.py` is a copy of
the port's roofline arithmetic. Nothing here imports jax, rene_tpu or
rene_tpu_torch, and nothing takes a table or a number the program made:
the benchmark hands both sides the same scene text and image seeds.
"""
