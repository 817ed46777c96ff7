"""Frozen copy of rene_tpu_torch/scene/__init__.py at commit ed2dcef.

Scene frontend of the port: the pbrt scene compiled to flat numpy
buffers (the port's copy of rene_tpu/scene), and `to_torch`, which moves
them onto a torch device."""
from . import types
from .device import RenderConfig, build_device_scene, to_torch
from .flatten import FlatScene, create_scene, load_scene

__all__ = ["RenderConfig", "build_device_scene", "FlatScene", "create_scene",
           "load_scene", "to_torch", "types"]
