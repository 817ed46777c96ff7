"""The port's tracing: spans on torch.profiler's clock, and the profiler.

`span(name)` marks a step of the program, named `rene.<layer>.<step>`. It
records only while a torch.profiler profile is active, as a
`record_function` that lands in the same Chrome trace as the CUDA
kernels and copies, so that the device's idle time can be put down to
the host's step. Outside a profiler it returns one shared no-op context:
an inactive `record_function` costs more than the check. Nesting in time
says which image a span belongs to; span names carry no ids.

`phases(prefix, split)` spans back-to-back phases (the wave engine's
init, sort, step and finish) and, with a `split` dict on a CUDA device,
times the same phases on the device with CUDA events.

`profiled(path)` runs torch.profiler (the CPU, and CUDA where torch sees
a card) around a block and writes its Chrome trace to `path`:
`python -m rene_tpu_torch.cli ... --trace PATH` and the probe use it.
`seconds(prof, name)` sums the spans of one name in a finished profile.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

OFF = contextlib.nullcontext()


def active() -> bool:
    """True while a torch.profiler profile records this thread."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context spanning a step of the program: `record_function(name)`
    under an active profiler, else the shared no-op `OFF`."""
    return torch.profiler.record_function(name) if active() else OFF


class phases:
    """Back-to-back phases: `phase(label)` ends the running phase and
    starts span `prefix + label`; leaving the context ends the last one.
    With `split` (a dict; CUDA only) a CUDA event is recorded at every
    boundary, and on exit the device ms between two boundaries is added
    to `split[label]` of the phase they bound."""

    def __init__(self, prefix: str, split: Optional[Dict] = None):
        self.prefix, self.split = prefix, split
        self.marks = []
        self.open = OFF

    def _boundary(self, label: Optional[str]) -> None:
        self.open.__exit__(None, None, None)
        self.open = OFF
        if self.split is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((label, ev))
        if label is not None:
            self.open = span(self.prefix + label)
            self.open.__enter__()

    def __enter__(self):
        return self._boundary

    def __exit__(self, exc_type, *_):
        self._boundary(None)
        if self.marks and exc_type is None:
            self.marks[-1][1].synchronize()
            for (label, e0), (_, e1) in zip(self.marks, self.marks[1:]):
                self.split[label] = (self.split.get(label, 0.0)
                                     + e0.elapsed_time(e1))
        return False


@contextlib.contextmanager
def profiled(path: Optional[str] = None):
    """torch.profiler around the block (the CPU, and CUDA where torch sees
    a card); yields the profile and writes its Chrome trace to `path`
    where given."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    if path:
        prof.export_chrome_trace(str(path))


def seconds(prof, name: str) -> float:
    """Seconds of the spans named `name` in the finished profile `prof`."""
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.name == name) * 1e-6
