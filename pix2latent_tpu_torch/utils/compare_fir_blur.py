"""Time versions of the K2 source against each other on one card, in turns.

    python -m pix2latent_tpu_torch.utils.compare_fir_blur \\
        [NAME=path/to/fir_blur.cu ...] [--levels 8,16,...] [--dtypes bf16,f32]
        [--reps 10]

Each NAME=SOURCE is built with the package's ``nvcc`` flags into
``pix2latent_tpu_torch/_build/compare/`` and called through its C entry
point ``fir_blur`` (the interface every version of ``csrc/fir_blur.cu`` has
kept); with no argument the package's own source is timed alone. For each
level of the StyleGAN2-cars-512 up path at population 22 (x [22, ch(r), r+1,
r+1], pad (1, 1), and the adjoint on [22, ch(r), r, r]), every version and
the depthwise ``F.conv2d`` are timed in turns, each launch with the L2 flushed
before it and a short device-side wait that covers the host's launch time
(both outside the CUDA events), median of ``--reps``. Prints the card's
``nvidia-smi`` line, ``ptxas`` register and spill lines of the 4-tap
instances, one JSON line per level and direction (times, bound, whether each
version's output is bitwise equal to the first's) and one line of sums over
the levels. An earlier version of the source comes from git, for example
``git show <commit>:pix2latent_tpu_torch/csrc/fir_blur.cu > _chipwork/old.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.models.stylegan2 import channels_for
from pix2latent_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC_DIR,
                                                   NVCC_FLAGS, nvcc_path)

TAPS = (0.25, 0.75, 0.75, 0.25)
PEAK_BYTES = 3.35e12
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def build(variants):
    """{name: ctypes library}, one nvcc each, all started together."""
    out_dir = BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in variants.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variants[name]}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "Li4E" in line:
                kind = "bf16" if "bfloat16" in line else "f32"
                print(name, kind, " | ".join(x.strip() for x in lines[i + 2:i + 4]),
                      flush=True)
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fir_blur.argtypes = [p, p, ctypes.POINTER(ctypes.c_float)] + [i] * 8 + [p]
        lib.fir_blur.restype = i
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", metavar="NAME=SOURCE")
    ap.add_argument("--levels", default="8,16,32,64,128,256,512")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    variants = dict(v.split("=", 1) for v in args.variants) or {
        "current": str(CSRC_DIR / "fir_blur.cu")}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(variants)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    taps = {False: (ctypes.c_float * 4)(*TAPS),
            True: (ctypes.c_float * 4)(*TAPS[::-1])}

    def call(lib, x, y, adjoint):
        n, c, h, w = x.shape
        err = lib.fir_blur(x.data_ptr(), y.data_ptr(), taps[adjoint], 4, n * c, h, w,
                           y.shape[2], y.shape[3], 2 if adjoint else 1,
                           int(x.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fir_blur launch failed: cudaError {err}")

    def cold(fn):
        flush.zero_()
        torch.cuda._sleep(200_000)    # keeps the card busy while the host launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    sums = {}
    for dname in args.dtypes.split(","):
        dtype = DTYPES[dname]
        size = 2 if dtype == torch.bfloat16 else 4
        for r in (int(v) for v in args.levels.split(",")):
            c = channels_for(r)
            big = torch.randn((22, c, r + 1, r + 1), device="cuda").to(dtype)
            small = torch.randn((22, c, r, r), device="cuda").to(dtype)
            k2 = torch.outer(torch.tensor(TAPS), torch.tensor(TAPS)).to(
                device="cuda", dtype=dtype)[None, None].repeat(c, 1, 1, 1)
            for key, x, y, adjoint in (("fwd", big, torch.empty_like(small), False),
                                       ("bwd", small, torch.empty_like(big), True)):
                fns = {name: (lambda lib=lib: call(lib, x, y, adjoint))
                       for name, lib in libs.items()}
                fns["conv"] = (lambda: F.conv2d(x, k2.flip(2, 3), padding=2, groups=c)
                               ) if adjoint else (
                    lambda: F.conv2d(x, k2, padding=1, groups=c))
                outs = {}
                for name in libs:
                    fns[name]()
                    torch.cuda.synchronize()
                    outs[name] = y.clone()
                first = next(iter(outs.values()))
                times = {name: [] for name in fns}
                for _ in range(args.reps):
                    for name, fn in fns.items():
                        times[name].append(cold(fn))
                row = {"dtype": dname, "r": r, "dir": key,
                       "bound_ms": 1e3 * size * (big.numel() + small.numel()) / PEAK_BYTES,
                       "ms": {n: statistics.median(t) for n, t in times.items()},
                       "bitwise_equal_to_first": {n: bool(torch.equal(o, first))
                                                  for n, o in outs.items()}}
                print(json.dumps(row), flush=True)
                for name, ms in list(row["ms"].items()) + [("bound", row["bound_ms"])]:
                    k = f"{dname}/{key}/{name}"
                    sums[k] = sums.get(k, 0.0) + ms
            del big, small
    print(json.dumps({"sums_ms": sums}), flush=True)


if __name__ == "__main__":
    main()
