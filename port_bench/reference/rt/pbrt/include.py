"""Frozen copy of rene_tpu_torch/pbrt/include.py at commit ed2dcef.

Textual `Include "file"` expansion, applied before parsing.

Matches the reference's behavior (pbrt-parser/src/include.rs:36-84):
recursively splices included files relative to the *top-level* scene's
directory; an `Include` token not followed by a quoted string is passed
through verbatim.
"""
from __future__ import annotations

import os
import re

_INC_RE = re.compile(r'Include(?:\s|#[^\n]*\n)*"((?:[^"\\]|\\.)*)"')


def expand_include(text: str, current_dir: str) -> str:
    out = []
    pos = 0
    while True:
        idx = text.find("Include", pos)
        if idx < 0:
            out.append(text[pos:])
            return "".join(out)
        out.append(text[pos:idx])
        m = _INC_RE.match(text, idx)
        if m is None:
            out.append("Include")
            pos = idx + len("Include")
            continue
        path = os.path.join(current_dir, m.group(1))
        with open(path, "r") as f:
            included = f.read()
        out.append(expand_include(included, current_dir))
        pos = m.end()
