"""Scene frontend of the port: the pbrt scene compiled to flat numpy
buffers (the port's copy of rene_tpu/scene), and `to_torch`, which moves
them onto a torch device."""
from .. import trace
from . import flatten, types
from .device import RenderConfig, build_device_scene, to_torch
from .flatten import FlatScene, create_scene

__all__ = ["RenderConfig", "build_device_scene", "FlatScene", "create_scene",
           "load_scene", "to_torch", "types"]


def load_scene(path: str, color_space: str = "linear") -> FlatScene:
    """Parse + flatten a .pbrt file from disk (`flatten.load_scene`, the
    copy of the reference's) inside span `rene.frontend.load`."""
    with trace.span("rene.frontend.load"):
        return flatten.load_scene(path, color_space)
