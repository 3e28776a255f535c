#!/usr/bin/env python3
"""Time the port's mailbox_gather kernel against the two designs it was
measured against, on one card, on the same inputs.

    python3 tools/torch_gather_ab.py [--out gather_ab.json]

Designs: "port", the kernel as the port launches it
(shadow_tpu_torch/csrc/mailbox_gather.cu with
insert_kernels.gather_geometry: one tile of up to 16 rows a block, the
tile's span in one bulk copy through shared memory); "first", the
port's first design of the kernel (tools/gather_designs/first.cu: 4 rows
a block of 128 threads, 4-byte copies); "register", a register-only
gather (tools/gather_designs/register.cu: one warp a row, two aligned
16-byte loads per 16-byte store, no shared memory). The two others are
built with insert_kernels.build_library, with the port's flags.
Each is held to the plain PyTorch version exactly (the register-only
gather also at chip_smoke.py's edge shapes), then timed with
chip_smoke.device_ms in turns (first, register, port, port, register,
first) at the route shapes chip_smoke.py times, on its synthetic inputs
(Poisson(8) arrivals a row): cold where chip_smoke.py's phase 3 is
(input sets cycled past the L2), else one input set. Prints a table,
the card's launch floor, and one JSON line (also written to --out).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
DESIGNS = ROOT / "tools" / "gather_designs"
WN = 32

# (label, H, n, P, cold): chip_smoke.py's phase-3 shapes and the
# route shapes of 19a, 20a, 16a, 22c and 24a
SHAPES = [
    ("main P=11 (phase 3)", 10_240, 245_760, 11, True),
    ("main P=11, one set (17a/18b/23a routes)", 10_240, 245_760, 11, False),
    ("relay P=22 (phase 3)", 10_240, 655_360, 22, True),
    ("Tor P=22 (phase 3)", 10_240, 2_621_440, 22, True),
    ("--test route (phase 3)", 1_001, 24_024, 22, True),
    ("19a route shape", 1_000, 8_000, 11, False),
    ("20a route shape", 2_560, 30_720, 11, False),
    ("x4 lanes route shape (16a)", 40_960, 983_040, 11, False),
    ("22c route shape", 65_536, 1_572_864, 11, False),
    ("24a route shape", 102_400, 2_457_600, 11, False),
]


def load(src: pathlib.Path, fn: str):
    """Build `src` and bind its launcher `fn`: (stream, start, out, H,
    rows, Wn, P, cuda stream) -> cudaError_t."""
    from shadow_tpu_torch.core import insert_kernels as ik

    f = getattr(ctypes.CDLL(str(ik.build_library(src)[0])), fn)
    f.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_gather_ab: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from shadow_tpu_torch.core import insert_kernels as ik

    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi} ({sms} SMs), torch {torch.__version__}", flush=True)
    ik.load_library()

    def launch(fn):
        def run(stream, start, Wn=WN):
            H, (rows, P) = start.numel(), stream.shape
            out = torch.empty((H, Wn, P), dtype=torch.int32, device=dev)
            rc = fn(stream.data_ptr(), start.data_ptr(), out.data_ptr(), H,
                    rows, Wn, P, torch.cuda.current_stream(dev).cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed with CUDA error {rc}")
            return out
        return run

    designs = {
        "first": launch(load(DESIGNS / "first.cu", "first_gather_launch")),
        "register": launch(load(DESIGNS / "register.cu",
                                "register_gather_launch")),
        "port": lambda stream, start: ik.mailbox_gather(stream, start, WN),
    }
    # the register-only gather at the port kernel's edge shapes too
    for label, sm, st, wn in cs.gather_edge_inputs(dev):
        if not torch.equal(designs["register"](sm, st, wn),
                           ik.mailbox_gather_ref(sm, st, wn)):
            raise AssertionError(f"register differs from the plain version "
                                 f"at {label}")
    floor_ms = cs.launch_floor_ms()
    print(f"launch floor (torch.cuda._sleep(0)): {floor_ms:.5f} ms",
          flush=True)
    rows_out = []
    for label, H, n, P, cold in SHAPES:
        n_sets = int(cs.COLD_BYTES // ((n + WN) * P * 4)) + 1 if cold else 1
        sets = [cs.mailbox_inputs(H, n, WN, P, seed=100 + k, device=dev)
                for k in range(n_sets)]
        want = ik.mailbox_gather_ref(*sets[0], WN)
        for name, fn in designs.items():
            if not torch.equal(fn(*sets[0]), want):
                raise AssertionError(f"{name} differs from the plain "
                                     f"version at {label}")
        ms = {name: [] for name in designs}
        for name in ("first", "register", "port", "port", "register",
                     "first"):
            fn = designs[name]
            ms[name].append(cs.device_ms(
                [lambda k=k: fn(*sets[k]) for k in range(n_sets)])[0])
        bound_ms = cs.mailbox_bound(*sets[0], WN)[0]
        row = {"shape": label, "H": H, "n": n, "P": P, "cold": cold,
               "sets": n_sets, "bound_ms": bound_ms, **ms}
        rows_out.append(row)
        print(f"{label}: H={H} n={n} P={P} {'cold' if cold else 'one set'}"
              f", bound {bound_ms:.5f} ms", flush=True)
        for name in designs:
            best = min(ms[name])
            print(f"    {name:8s} {ms[name][0]:.5f} {ms[name][1]:.5f} ms "
                  f"({bound_ms / best * 100:.1f}% of the bound)", flush=True)
        del sets, want
    result = {"card": smi, "sms": sms, "launch_floor_ms": floor_ms,
              "shapes": rows_out}
    line = json.dumps(result)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
