"""Film checkpoint and resume: npz snapshots of the render loop's sums.

Counterpart of rene_tpu/utils/checkpoint.py (`scene_fingerprint` :21,
`save_checkpoint` :36, `load_checkpoint` :44). A snapshot holds what a
resumed render needs to add, in the same order, exactly what an unbroken
one adds:

* the film's three sums (radiance, normal, albedo) and `samples_done`;
* `seeds`, the number of chunk seeds drawn, so that a resume draws past
  exactly those (the reference recounts chunks of the resuming runner's
  size, rene_tpu/render.py:344-348);
* for a `want_var` render, `sq_sum`, the per-chunk sums of squares that
  `varmean` is made from: a snapshot without them would give a variance
  over the chunks run since the resume alone (the reference's
  rene_tpu/render.py:362-378).

The fingerprint names the resolved runner (`megakernel`, `wave` or
`xla`) and `want_var` besides the scene buffers, the config and the seed,
so that a snapshot of one runner is not offered to another, whose chunk
streams differ, nor a plain snapshot to a `want_var` render.
"""
from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, Optional

import numpy as np

log = logging.getLogger("rene_tpu_torch.checkpoint")

SUMS = ("radiance", "normal", "albedo")


def scene_fingerprint(buffers_np: dict, config, seed: int, runner: str,
                      want_var: bool) -> str:
    """Hash of what makes two accumulations compatible: the flat scene
    buffers, the static config, the host seed, the resolved runner and
    whether the render keeps per-chunk sums of squares."""
    h = hashlib.sha1()
    h.update(repr(config).encode())
    h.update(f"seed={int(seed)};runner={runner};"
             f"want_var={bool(want_var)}".encode())
    for k in sorted(buffers_np):
        v = np.ascontiguousarray(buffers_np[k])
        h.update(k.encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()


def save_checkpoint(path: str, accum: Dict[str, np.ndarray],
                    samples_done: int, fingerprint: str, seeds: int,
                    sq_sum: Optional[np.ndarray] = None) -> None:
    """Write the snapshot to a temporary file beside `path`, then move it
    over `path`: a reader sees the old snapshot or the new one, never a
    part of one. Uncompressed, unlike the reference's: a render writes
    one after every chunk, and a 1280x720 film's compressed write takes
    ~20x as long (chip_smoke.py phase 27 times both)."""
    tmp = path + ".tmp.npz"
    extra = {} if sq_sum is None else {"sq_sum": sq_sum}
    try:
        with open(tmp, "wb") as f:
            np.savez(
                f, samples_done=samples_done, seeds=seeds,
                fingerprint=np.bytes_(fingerprint.encode()),
                **{k: accum[k] for k in SUMS}, **extra)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, fingerprint: str) -> Optional[dict]:
    """The snapshot at `path` as {"accum", "samples_done", "seeds",
    "sq_sum" (None without)}, or None where there is none or it was
    written for another fingerprint (with the reference's warning)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        saved = (z["fingerprint"].item().decode() if "fingerprint" in z
                 else None)
        if saved != fingerprint or "seeds" not in z:
            log.warning(
                "checkpoint %s was written for a different scene/seed/"
                "engine; ignoring it (delete the file to silence this)",
                path)
            return None
        return {"accum": {k: z[k] for k in SUMS},
                "samples_done": int(z["samples_done"]),
                "seeds": int(z["seeds"]),
                "sq_sum": z["sq_sum"] if "sq_sum" in z else None}
