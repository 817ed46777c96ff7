"""load_s (s), layer frontend: the port's parse and flatten of the scene
file in set-up (`scene.load_scene`; host clock)."""


def read(ctx):
    return ctx["setup"]["load_s"]
