"""setup_s (s): the process's start to the end of the warm image: torch and
the CUDA context, the scene text, the port's parse and tables, nvcc where
the checkout lacks the libraries, one image (host clock)."""


def read(ctx):
    return ctx["setup"]["setup_s"]
