"""Scene frontend for the port: rene_tpu's numpy-only loaders, re-exported,
plus `to_torch` (the counterpart of rene_tpu/scene/device.py:417 to_jax)."""
from rene_tpu.scene import types
from rene_tpu.scene.device import RenderConfig, build_device_scene
from rene_tpu.scene.flatten import FlatScene, create_scene, load_scene

from .device import to_torch

__all__ = ["RenderConfig", "build_device_scene", "FlatScene", "create_scene",
           "load_scene", "to_torch", "types"]
