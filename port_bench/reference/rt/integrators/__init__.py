"""Frozen copy of rene_tpu_torch/integrators/__init__.py at commit ed2dcef.

Integrators of the port: the path megakernel (slice K1a)."""
