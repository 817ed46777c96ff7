"""The Mosaic probes P-r3n and P-r3w on the card (csrc/probes.cu).

    python -m rene_tpu_torch.probes

Prints the lines of scripts/tpu_session_r3n.py (P1 astype, P2 bitcast, P3
octant: OK when the (8, 128) block read for groups 0, 3 and 15 is perm[si]
and equals the plain version bit for bit, else MISMATCH) and of
scripts/tpu_session_r3w.py (M1 hi, M2 def, M3 vpu: microseconds per rep,
the script's 200 runs inside one launch, timed by CUDA events over five
launches after a first; the largest difference from the plain version relative to
|B| |R|, or bit for bit for vpu; the launches queued behind a spin kernel,
so that host time does not count). M4, the side-test agreement of
ops/mxu_intersect.py, waits for that module (ROADMAP Queue 1 item 4).
Needs a CUDA card; exits nonzero without one or when a probe disagrees.
"""
from __future__ import annotations

import sys

import torch

from . import kernels
from .ops import probes as PR

R3N_NAMES = {1: "P1 astype", 2: "P2 bitcast", 3: "P3 octant"}
R3W_NAMES = {"hi": "M1 mma 3xTF32 (384,8)@(8,1024)",
             "def": "M2 mma bf16 (384,8)@(8,1024)",
             "vpu": "M3 cuda cores 32x6-op chain (8,128)"}
# P-r3w against the plain versions, relative to |B| |R| (bit for bit for
# vpu): 3xTF32 keeps float32's accuracy; the bf16 pass rounds its
# operands as the plain version does, so only the float32 sum of eight
# exact products differs (a product at full precision, or in TF32, is
# ~1e-3 off)
R3W_TOL = {"hi": 1e-5, "def": 1e-5}
LAUNCHES = 5
# cycles of the spin kernel queued ahead of the timed launches (~1 ms),
# longer than the host takes to queue them
QUEUE_AHEAD = 2_000_000


def launch_ms(fn, calls: int = 1) -> float:
    """Milliseconds of one launch of `fn` on the card, or of `calls` calls
    of it one after another: CUDA events over LAUNCHES such launches after
    a first, queued behind a spin kernel (as long again for each call) so
    that the card runs them back to back (a probe's launch is as short as
    the host's work to queue it)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_AHEAD * calls)
    start.record()
    for _ in range(LAUNCHES * calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def r3n(device) -> dict:
    """{mode: (ok, ms of one launch)}: probe `mode` for the script's groups
    against perm[si] and the plain version, bit for bit."""
    perm, box, geom = PR.r3n_tables()
    box, geom = box.to(device), geom.to(device)
    out = {}
    for mode, name in R3N_NAMES.items():
        ok = True
        for si in PR.R3N_SIS:
            got = kernels.rowslice_probe(mode, si, box, geom)
            want = PR.rowslice_ref(mode, si, box, geom)
            if not (torch.equal(got, want)
                    and bool((got == float(perm[si])).all())):
                ok = False
                print(f"  {name}: si={si} got {got[0, :4].tolist()} want "
                      f"{float(perm[si])}", flush=True)
        ms = launch_ms(lambda: kernels.rowslice_probe(mode, 3, box, geom))
        print(f"{name}: {'OK' if ok else 'MISMATCH'} ({ms * 1e3:.2f} us per "
              f"launch)", flush=True)
        out[mode] = (ok, ms)
    return out


def r3w(device) -> dict:
    """{kind: {ok, err, us_per_rep, out}}: each kind at R3W_REPS runs per
    launch against its plain version."""
    reps = PR.R3W_REPS
    b, r = PR.r3w_inputs()
    b, r = b.to(device), r.to(device)
    scale = PR.product_scale(b, r)
    out = {}
    for kind, name in R3W_NAMES.items():
        got = kernels.mxu_probe(kind, b, r, reps)
        want = PR.mxu_ref(kind, b, r, reps)
        if kind == "vpu":
            err = float((got - want).abs().max())
            ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        else:
            err = float(((got - want).abs() / scale).max())
            ok = err <= R3W_TOL[kind]
        ms = launch_ms(lambda: kernels.mxu_probe(kind, b, r, reps))
        us = ms * 1e3 / reps
        print(f"{name}: {us:.4f} us/iter  out[0,:2]="
              f"{got[0, :2].tolist()}  vs plain "
              + ("bit for bit " + str(ok) if kind == "vpu"
                 else f"{err:.3g} of |B||R| (limit {R3W_TOL[kind]})"),
              flush=True)
        out[kind] = {"ok": ok, "err": err, "ms": ms, "us_per_rep": us,
                     "out": got}
    print("M4 side-test agreement: not run (ops/mxu_intersect.py is ROADMAP "
          "Queue 1 item 4)", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print("platform: gpu", torch.cuda.get_device_name(0), flush=True)
    n = r3n(device)
    w = r3w(device)
    return 0 if all(ok for ok, _ in n.values()) \
        and all(v["ok"] for v in w.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
