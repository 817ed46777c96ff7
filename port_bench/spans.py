"""The program's own spans in a traced window: the `rene.*` spans that
rene_tpu_torch/trace.py records under torch.profiler, on the clock of the
device's activity.

`idle_parts(trace)` splits the device's idle time inside the window's
`rene.loop.image` spans by what the host was doing, exactly, by interval
intersection: the window is cut at every span's start and end, each piece
takes the part of the image that the spans covering it name (`chunks`
inside a `rene.loop.chunk`, with what it holds: the launch, the wait;
`readback` inside `rene.loop.readback`; `film` inside `rene.loop.film`;
`other` inside an image and none of these), and each part sums the idle
time of its pieces. So the parts add up to the idle time inside the
images. A program without these spans (one older than them) gives None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

IMAGE = "rene.loop.image"
PARTS = (("rene.loop.chunk", "chunks"), ("rene.loop.readback", "readback"),
         ("rene.loop.film", "film"))


def program_spans(trace) -> List[Tuple[float, float, str]]:
    """(start, end, name) of the trace's `rene.` spans, cut to the window."""
    lo, hi = trace.window
    return [(max(s, lo), min(t, hi), n) for n, s, t in trace.host
            if n.startswith("rene.") and min(t, hi) > max(s, lo)]


def image_seconds(trace) -> List[float]:
    """The duration of each `rene.loop.image` span in the window."""
    return [t - s for s, t, n in program_spans(trace) if n == IMAGE]


def idle_before(trace, x) -> np.ndarray:
    """The device's idle seconds between the window's start and each time
    in `x` (inside the window)."""
    lo, _ = trace.window
    x = np.asarray(x, dtype=np.float64)
    busy = np.asarray(trace.busy(), dtype=np.float64).reshape(-1, 2)
    if not busy.size:
        return x - lo
    starts, lengths = busy[:, 0], busy[:, 1] - busy[:, 0]
    before = np.concatenate([[0.0], np.cumsum(lengths)])
    # the busy intervals that start by x: all but the last have ended
    i = np.searchsorted(starts, x, side="right")
    last = np.maximum(i - 1, 0)
    partial = np.where(i > 0, np.minimum(x - starts[last], lengths[last]),
                       0.0)
    return (x - lo) - (before[last] + partial)


def idle_parts(trace) -> Optional[Dict[str, float]]:
    """Idle seconds of the device inside the window's image spans by part
    (`chunks`, `readback`, `film`, `other`), their sum (`image`), the
    window's (`window`) and the count of image spans (`images`); None
    without a trace or without image spans."""
    if trace is None:
        return None
    spans = program_spans(trace)
    images = sum(1 for _, _, n in spans if n == IMAGE)
    if not images:
        return None
    lo, hi = trace.window
    cuts = np.unique(np.array([lo, hi] + [x for s, t, _ in spans
                                          for x in (s, t)]))
    idle = np.diff(idle_before(trace, cuts))
    # the names of the spans covering each piece [cuts[k], cuts[k + 1])
    opened: Dict[int, List[str]] = {}
    closed: Dict[int, List[str]] = {}
    for s, t, n in spans:
        opened.setdefault(int(np.searchsorted(cuts, s)), []).append(n)
        closed.setdefault(int(np.searchsorted(cuts, t)), []).append(n)
    parts = dict.fromkeys(("chunks", "readback", "film", "other"), 0.0)
    covering: Dict[str, int] = {}
    for k, seconds in enumerate(idle):
        for n in closed.get(k, ()):
            covering[n] -= 1
        for n in opened.get(k, ()):
            covering[n] = covering.get(n, 0) + 1
        if not covering.get(IMAGE):
            continue
        part = next((p for n, p in PARTS if covering.get(n)), "other")
        parts[part] += float(seconds)
    parts.update(image=sum(parts.values()),
                 window=float(idle_before(trace, [hi])[0]), images=images)
    return parts


def idle_ms_per_image(ctx, part: str) -> Optional[float]:
    """The part's idle ms per traced image, or None (idle_parts)."""
    parts = idle_parts(ctx["trace"])
    return None if parts is None else 1e3 * parts[part] / parts["images"]
