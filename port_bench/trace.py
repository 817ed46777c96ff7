"""The traced window: torch.profiler around it, its trace read back.

`Tracer` records the window (CPU and CUDA activity, a span
"port_bench.window" around it and one "port_bench.image" per image);
`Trace` holds what the metric readers need from its chrome trace: the
device's kernels, copies and sets, the host's operations, the window's
bounds, all in seconds on the trace's clock.
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Dict, List, Tuple

import numpy as np

WINDOW, IMAGE = "port_bench.window", "port_bench.image"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# the harness's names for the device's operations, first match wins
OP_NAMES = (
    (r"mega_volpath_kernel", "megakernel (volpath)"),
    (r"mega_path_kernel", "megakernel (path)"),
    (r"[Rr]adix[Ss]ort|[Ss]ort", "torch sort"),
    (r"index_select|gather|[Ii]ndex", "torch gather"),
    (r"[Rr]educe", "torch reduce"),
    (r"elementwise|[Ff]ill|copy_kernel", "torch elementwise"),
    (r"Memcpy DtoH|Memcpy.*Device -> Pageable|DtoH", "copy device to host"),
    (r"Memcpy HtoD|HtoD", "copy host to device"),
    (r"Memcpy DtoD|DtoD", "copy device to device"),
    (r"Memset|memset", "memset"),
)


def op_name(raw: str) -> str:
    for pat, name in OP_NAMES:
        if re.search(pat, raw):
            return name
    return raw[:64]


class Tracer:
    """Context that profiles the window on `device`; `mark(i)` spans
    image i."""

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = device
        self.prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        self._win = self.torch.profiler.record_function(WINDOW)
        self._win.__enter__()
        return self

    def __exit__(self, *exc):
        self._win.__exit__(*exc)
        self.torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        return False

    def mark(self, i: int):
        return self.torch.profiler.record_function(IMAGE)

    def parse(self) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return Trace(events)


class Trace:
    """The window's events: `device` and `host` lists of (name, start,
    end) in seconds, the window's (start, end), the images traced."""

    def __init__(self, events: List[Dict]):
        self.device, self.host = [], []
        self.window = None
        self.images = 0
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat, name = e.get("cat", ""), e.get("name", "")
            s = float(e["ts"]) * 1e-6
            t = s + float(e["dur"]) * 1e-6
            if cat in DEVICE_CATS:
                self.device.append((name, s, t))
            elif cat in HOST_CATS:
                if name == WINDOW and cat == "user_annotation":
                    self.window = (s, t)
                elif name == IMAGE and cat == "user_annotation":
                    self.images += 1
                self.host.append((name, s, t))
        if self.window is None:
            raise RuntimeError("the trace holds no window span")
        lo, hi = self.window
        self.device = [(n, max(s, lo), min(t, hi)) for n, s, t in
                       self.device if t > lo and s < hi]

    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device's activity as sorted intervals."""
        out = []
        for _, s, t in sorted(self.device, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], t)
            else:
                out.append([s, t])
        return [(s, t) for s, t in out]

    def busy_s(self) -> float:
        return float(sum(t - s for s, t in self.busy()))

    def idle_share(self) -> float:
        return 100.0 * (1.0 - self.busy_s() / self.window_s())

    def seconds(self, pattern: str) -> float:
        """Device seconds of the operations whose name matches."""
        rx = re.compile(pattern)
        return float(sum(t - s for n, s, t in self.device if rx.search(n)))

    def device_ops(self, n: int = 10) -> List[List]:
        by = {}
        for name, s, t in self.device:
            key = op_name(name)
            by[key] = by.get(key, 0.0) + (t - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])
                [:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time in the window, summed by what the host
        was doing at each gap's middle (its innermost operation or span),
        the largest n."""
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy() for x in iv] + [hi]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        host = [h for h in self.host if h[0] != WINDOW]
        names = [h[0] for h in host]
        hs = np.array([h[1] for h in host]) if host else np.zeros(0)
        he = np.array([h[2] for h in host]) if host else np.zeros(0)
        by: Dict[str, float] = {}
        for a, b in gaps:
            m = 0.5 * (a + b)
            inside = np.nonzero((hs <= m) & (he >= m))[0]
            if not inside.size:
                label = "host: harness, between images"
            else:
                name = names[inside[np.argmin(he[inside] - hs[inside])]]
                label = ("host: render_loop, outside torch" if name == IMAGE
                         else "host: " + name[:60])
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])
                [:n]]

    def breakdown(self) -> Dict:
        return {"device_ops": self.device_ops(), "idle_gaps": self.idle_gaps()}
