"""The Mosaic probes P-r3n and P-r3w on the card (csrc/probes.cu).

    python -m rene_tpu_torch.probes [--floors]

Prints the lines of scripts/tpu_session_r3n.py (P1 astype, P2 bitcast, P3
octant: OK when the (8, 128) block read for groups 0, 3 and 15 is perm[si]
and equals the plain version bit for bit, else MISMATCH) and of
scripts/tpu_session_r3w.py (M1 hi, M2 def, M3 vpu: microseconds per rep,
the script's 200 runs inside one launch, timed by CUDA events over five
launches after a first, queued behind a spin kernel so that host time
does not count; the largest difference from the plain version relative
to |B| |R|, or bit for bit for vpu; the time at 200 reps over the time at
100, each less the time at one rep; M4: the side-test signs of
ops/mxu_intersect.py's products on the card against the script's
Möller–Trumbore loop, over 40 triangles and 16 rays). Needs a CUDA
card; exits nonzero without one or when a probe disagrees.

--floors also prints what the chain floors are made of (the latency of
each link of csrc/probes.cu floor_kernel in SM cycles, the SM clock, an
empty launch) and each probe's floor: an empty launch plus its critical
path per rep (`chain`) times R3W_REPS, at the measured latencies and clock.
"""
from __future__ import annotations

import sys

import torch

from . import kernels
from .ops import probes as PR

R3N_NAMES = {1: "P1 astype", 2: "P2 bitcast", 3: "P3 octant"}
R3W_NAMES = {"hi": "M1 wgmma 3xTF32 (384,8)@(8,1024)",
             "def": "M2 mma.sync bf16 (384,8)@(8,1024)",
             "vpu": "M3 cuda cores 32x6-op chain (8,128)"}
# P-r3w against the plain versions, relative to |B| |R| (bit for bit for
# vpu): 3xTF32 keeps float32's accuracy; the bf16 pass rounds its
# operands as the plain version does, so only the float32 sum of eight
# exact products differs (a product at full precision, or in TF32, is
# ~1e-3 off)
R3W_TOL = {"hi": 1e-5, "def": 1e-5}
# ms per launch of the probes before their redesign for the card (one
# mma.sync tile a warp, the chain with its loads and NaN branches, a float
# a thread), printed beside the kept kernels' times: the means of two
# turns on an NVIDIA H100 80GB HBM3 at 700 W, run before and after the
# redesign in one call (PERF.md section 6, the P-r3w and P-r3n rows)
PARENT_MS = {"rowslice_probe": 0.00290, "hi": 0.02953, "def": 0.01180,
             "vpu": 0.70393}
# M4's triangles x rays
M4_PAIRS = 40 * 16
# the reps at which a launch is timed against R3W_REPS: a kernel whose
# reps were hoisted out of its loop would take about as long at both. The
# two times, each less the same kernel's time at one rep (its launch,
# loads and stores), are at least RATIO_MIN apart. The times themselves
# are not, where the launch is a large share of them (200 reps of the
# bf16 product take ~3.5x an empty launch); and the reps' part counts at
# least a tenth of the one-rep time, so that a kernel whose reps cost
# nothing reads ~0, not a ratio of two noises
HALF_REPS = 100
RATIO_MIN = 1.6
LAUNCHES = 5
# the links of csrc/probes.cu floor_kernel and floor_wg_kernel, in their
# FLOOR_* order ("fadd" stands for an FFMA too: the same latency; "wg_hi"
# is a whole rep of hi, its dep, split and group of three wgmmas)
FLOOR_KINDS = ("fmul", "fadd", "minmax", "cvt_bf16", "hmma_bf16", "wg_hi")
# links of a floor chain: the cycles per link are the difference of two
# lengths over their difference, which takes out the chain's ends
FLOOR_ITERS = (256, 2048)
# cycles of the spin kernel whose event time gives the SM clock
CLOCK_CYCLES = 20_000_000
# cycles of the spin kernel queued ahead of the timed launches (~1 ms),
# longer than the host takes to queue them
QUEUE_AHEAD = 2_000_000


def chain(kind: str) -> dict:
    """One rep's critical path in links of FLOOR_KINDS (read from the
    SASS, PERF.md section 6). vpu: a step's 14 operations; hi: the rep
    as floor_wg_kernel times it whole; def: dep, the bf16 pack, the
    HMMA."""
    if kind == "vpu":
        return {"fmul": 6 * PR.R3W_STEPS, "fadd": 5 * PR.R3W_STEPS,
                "minmax": 3 * PR.R3W_STEPS}
    if kind == "hi":
        return {"wg_hi": 1}
    return {"fadd": 1, "cvt_bf16": 1, "hmma_bf16": 1}


def chain_floor_ms(path: dict, fl: dict, reps: int = PR.R3W_REPS) -> float:
    """An empty launch plus `reps` runs of the critical path `path` at the
    latencies and clock of `fl` (floors)."""
    cycles = sum(n * fl["cycles"][k] for k, n in path.items()) * reps
    return fl["empty_ms"] + cycles / (fl["ghz"] * 1e6)


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


def latencies(device) -> dict:
    """{FLOOR_KINDS name: SM cycles of one link of its dependent chain}
    (csrc/probes.cu floor_kernel, clock64)."""
    lo, hi = FLOOR_ITERS
    return {name: (kernels.floor_probe(i, hi, device)
                   - kernels.floor_probe(i, lo, device)) / (hi - lo)
            for i, name in enumerate(FLOOR_KINDS)}


def clock_ghz(device) -> float:
    """The SM clock under a spin kernel: CLOCK_CYCLES of clock64 over
    their event time."""
    torch.cuda._sleep(1000)
    ms = launch_ms(lambda: torch.cuda._sleep(CLOCK_CYCLES))
    return CLOCK_CYCLES / (ms * 1e6)


def floors(device, verbose: bool = True) -> dict:
    """What the chain floors are made of: each link's cycles, the SM clock
    and the ms of an empty launch; and each probe's floor in ms (P-r3n:
    the empty launch)."""
    fl = {"cycles": latencies(device), "ghz": clock_ghz(device),
          "empty_ms": launch_ms(lambda: kernels.empty_probe(device))}
    fl["floor_ms"] = {"rowslice_probe": fl["empty_ms"]}
    for kind in kernels.MXU_KINDS:
        fl["floor_ms"][kind] = chain_floor_ms(chain(kind), fl)
    if verbose:
        for name, c in fl["cycles"].items():
            print(f"latency {name}: {c:.2f} cycles", flush=True)
        print(f"SM clock under a spin: {fl['ghz']:.4f} GHz; empty launch: "
              f"{fl['empty_ms'] * 1e3:.3f} us", flush=True)
        for k, ms in fl["floor_ms"].items():
            print(f"chain floor {k}: {ms * 1e3:.3f} us", flush=True)
    return fl


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


def _agrees(kind, got, want, scale):
    """(ok, err): bit for bit for vpu (err the largest difference), else
    the largest difference relative to |B| |R| within R3W_TOL."""
    if kind == "vpu":
        return (torch.equal(got.view(torch.int32), want.view(torch.int32)),
                float((got - want).abs().max()))
    err = float(((got - want).abs() / scale).max())
    return err <= R3W_TOL[kind], err


def m4(device) -> float:
    """M4 (tpu_session_r3w.py :110-138): the share of the script's 40
    triangles x 16 rays whose side-test hit, from the products of
    ops/mxu_intersect.py on `device`, agrees with the float32 Möller–
    Trumbore loop on the host."""
    from .ops.mxu_intersect import MXUIntersector
    tri, o, d = PR.m4_inputs()
    mx = MXUIntersector(tri, device=device)
    sides = mx.sides(o, d).cpu().numpy()
    hit = PR.m4_hits(sides, mx.padded, mx.num_tris)
    return float((hit == PR.m4_mt_hits(tri, o, d)).mean())


def r3w(device) -> dict:
    """{kind: {ok, err, ms, us_per_rep, half_ms, one_ms, ratio, out}}:
    each kind at R3W_REPS runs per launch against its plain version, and
    its time at R3W_REPS over its time at HALF_REPS, each less its time at
    one rep; "m4": M4's agreement on `device`."""
    reps = PR.R3W_REPS
    b, r = PR.r3w_inputs()
    b, r = b.to(device), r.to(device)
    scale = PR.product_scale(b, r)
    out = {}
    for kind, name in R3W_NAMES.items():
        got = kernels.mxu_probe(kind, b, r, reps)
        ok, err = _agrees(kind, got, PR.mxu_ref(kind, b, r, reps), scale)
        ms = launch_ms(lambda: kernels.mxu_probe(kind, b, r, reps))
        half = launch_ms(lambda: kernels.mxu_probe(kind, b, r, HALF_REPS))
        one = launch_ms(lambda: kernels.mxu_probe(kind, b, r, 1))
        ratio = (ms - one) / max(half - one, 0.1 * one)
        us = ms * 1e3 / reps
        print(f"{name}: {us:.4f} us/iter  out[0,:2]="
              f"{got[0, :2].tolist()}  vs plain "
              + ("bit for bit " + str(ok) if kind == "vpu"
                 else f"{err:.3g} of |B||R| (limit {R3W_TOL[kind]})")
              + f"; {reps} reps / {HALF_REPS} reps: {ms / half:.3f}, less "
              f"one rep's launch ({one * 1e3:.3f} us) {ratio:.3f} (at least "
              f"{RATIO_MIN})", flush=True)
        out[kind] = {"ok": ok, "err": err, "ms": ms, "us_per_rep": us,
                     "half_ms": half, "one_ms": one, "ratio": ratio,
                     "out": got}
    out["m4"] = m4(device)
    print(f"M4 sign-test agreement vs MT: {out['m4'] * 100:.2f}%",
          flush=True)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m rene_tpu_torch.probes")
    ap.add_argument("--floors", action="store_true",
                    help="also measure the chain floors")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probes: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print("platform: gpu", torch.cuda.get_device_name(0), flush=True)
    if args.floors:
        floors(device)
    n = r3n(device)
    w = r3w(device)
    return 0 if all(ok for ok, _ in n.values()) and all(
        w[k]["ok"] and w[k]["ratio"] >= RATIO_MIN
        for k in kernels.MXU_KINDS) and m4_agrees(w["m4"]) else 1


def m4_agrees(card: float) -> bool:
    """M4 on the card within one of its 640 pairs of M4 on the CPU."""
    cpu = m4(torch.device("cpu"))
    ok = abs(card - cpu) <= 1.5 / M4_PAIRS
    print(f"M4 on the CPU: {cpu * 100:.2f}%; the card "
          f"{'agrees' if ok else 'DISAGREES'} within one pair", flush=True)
    return ok


if __name__ == "__main__":
    sys.exit(main())
