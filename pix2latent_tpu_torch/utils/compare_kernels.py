"""Time versions of a kernel's CUDA source against each other on one card,
in turns.

    python -m pix2latent_tpu_torch.utils.compare_kernels KERNEL \\
        [NAME=path/to/source.cu[@ABI] ...] [--dtypes bf16,f32] [--reps N]
        [--levels 8,16,...]

``KERNEL`` is ``fir_blur`` (K2) or ``mod_backward`` (K3). Each NAME=SOURCE
is built with the package's ``nvcc`` flags into
``pix2latent_tpu_torch/_build/compare/`` (one ``nvcc`` each, all started
together) and called through the kernel's C entry under the calling
convention ``ABI`` (default: the package's present one):

- ``fir_blur``: ``fir_blur``, the entry every version of
  ``csrc/fir_blur.cu`` has kept. Cases: each level of the StyleGAN2-cars-512
  up path at population 22 (``--levels``; x [22, ch(r), r+1, r+1], pad
  (1, 1), and the adjoint on [22, ch(r), r, r]) beside the depthwise
  ``F.conv2d``, each launch with the L2 flushed before it; sums over the
  levels. Prints the ``ptxas`` register and spill lines of the 4-tap
  instances.
- ``mod_backward``: ``plan``, whose entry takes the plan (``splits``,
  ``threads``, ``vec``) from ``ops/mod_backward.py``'s
  ``mod_backward_plan``, or ``plane``, the first design's entry (one block
  a plane, no plan). Cases: the largest K3 shapes of the StyleGAN2 paths
  (cars-512 at population 22, [22, 64, 512, 512]; an FFHQ-1024 chunk of 2,
  [2, 32, 1024, 1024] and [2, 64, 512, 512]) beside the unfused composite
  (``g * s`` and the f32 ``(g * x).sum``), back to back.

Every launch sits behind a short device-side wait that covers the host's
time to launch it (outside the CUDA events); each time is the median of
``--reps``. With no NAME=SOURCE the package's own source is timed alone.
Prints the card's ``nvidia-smi`` line, one JSON line per case (times, the
bytes bound at 3.35 TB/s, whether each version's outputs are bitwise equal
to the first version's) and one line of sums. An earlier version of a
source comes from git, for example
``git show <commit>:pix2latent_tpu_torch/csrc/mod_backward.cu > _chipwork/old.cu``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from pix2latent_tpu_torch.utils.cuda_build import (BUILD_DIR, CSRC_DIR,
                                                   NVCC_FLAGS, nvcc_path)

PEAK_BYTES = 3.35e12
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
SLEEP_CYCLES = 200_000
FLUSH_BYTES = 128 * 2 ** 20           # more than the 50 MB L2
FIR_TAPS = (0.25, 0.75, 0.75, 0.25)
MOD_SHAPES = ((22, 64, 512, 512), (2, 32, 1024, 1024), (2, 64, 512, 512))

_p, _i = ctypes.c_void_p, ctypes.c_int
# kernel: (C entry, {ABI: argument types}, present ABI, ptxas lines to
# print, cold)
KERNELS = {
    "fir_blur": ("fir_blur",
                 {"fir_blur": [_p, _p, ctypes.POINTER(ctypes.c_float)]
                  + [_i] * 8 + [_p]},
                 "fir_blur", "Li4E", True),
    "mod_backward": ("mod_backward",
                     {"plan": [_p] * 5 + [_i] * 6 + [_p],
                      "plane": [_p] * 5 + [_i] * 3 + [_p]},
                     "plan", "", False),
}


def parse_variants(kernel, specs):
    """``{name: (source, abi)}`` from ``NAME=SOURCE[@ABI]`` arguments; the
    package's own source alone when there are none."""
    _, abis, default, _, _ = KERNELS[kernel]
    if not specs:
        return {"current": (str(CSRC_DIR / f"{kernel}.cu"), default)}
    variants = {}
    for spec in specs:
        name, sep, rest = spec.partition("=")
        if not sep or not name or not rest:
            raise ValueError(f"expected NAME=SOURCE[@ABI], got {spec!r}")
        source, _, abi = rest.partition("@")
        abi = abi or default
        if abi not in abis:
            raise ValueError(f"{kernel} has the calling conventions "
                             f"{sorted(abis)}, got {abi!r}")
        variants[name] = (source, abi)
    return variants


def build(kernel, variants):
    """``{name: (ctypes library, abi)}``, one nvcc each, all started
    together."""
    entry, abis, _, ptxas_key, _ = KERNELS[kernel]
    out_dir = BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, _) in variants.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variants[name][0]}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and ptxas_key in line:
                print(name, line.split("'")[1][:60], "|",
                      " | ".join(x.strip() for x in lines[i + 2:i + 4]),
                      flush=True)
        abi = variants[name][1]
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = abis[abi]
        fn.restype = _i
        libs[name] = (fn, abi)
    return libs


def _raise_on(err, kernel):
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def fir_blur_cases(libs, dtypes, levels):
    """``(row, bytes, {name: fn}, {name: outputs})`` for each level and
    direction of the cars-512 up path."""
    from pix2latent_tpu_torch.models.stylegan2 import channels_for

    taps = {False: (ctypes.c_float * 4)(*FIR_TAPS),
            True: (ctypes.c_float * 4)(*FIR_TAPS[::-1])}

    def call(fn, x, y, adjoint):
        n, c, h, w = x.shape
        _raise_on(fn(x.data_ptr(), y.data_ptr(), taps[adjoint], 4, n * c, h,
                     w, y.shape[2], y.shape[3], 2 if adjoint else 1,
                     int(x.dtype == torch.bfloat16),
                     torch.cuda.current_stream().cuda_stream), "fir_blur")

    for dname in dtypes:
        dtype = DTYPES[dname]
        for r in levels:
            c = channels_for(r)
            big = torch.randn((22, c, r + 1, r + 1), device="cuda").to(dtype)
            small = torch.randn((22, c, r, r), device="cuda").to(dtype)
            k2 = torch.outer(torch.tensor(FIR_TAPS), torch.tensor(FIR_TAPS)).to(
                device="cuda", dtype=dtype)[None, None].repeat(c, 1, 1, 1)
            nbytes = big.element_size() * (big.numel() + small.numel())
            for key, x, like, adjoint in (("fwd", big, small, False),
                                          ("bwd", small, big, True)):
                outs = {name: (torch.empty_like(like),) for name in libs}
                fns = {name: (lambda fn=fn, y=outs[name][0]:
                              call(fn, x, y, adjoint))
                       for name, (fn, _) in libs.items()}
                fns["conv"] = (
                    (lambda: F.conv2d(x, k2.flip(2, 3), padding=2, groups=c))
                    if adjoint else
                    (lambda: F.conv2d(x, k2, padding=1, groups=c)))
                yield {"dtype": dname, "r": r, "dir": key}, nbytes, fns, outs
                del outs
            del big, small


def mod_backward_cases(libs, dtypes, levels=None):
    """``(row, bytes, {name: fn}, {name: outputs})`` for each K3 shape."""
    from pix2latent_tpu_torch.ops.mod_backward import mod_backward_plan

    def call(fn, abi, g, x, s, gx, gs):
        n, c, h, w = g.shape
        ints = [n * c, h * w, int(g.dtype == torch.bfloat16)]
        if abi == "plan":
            ints += list(mod_backward_plan(n * c, h * w,
                                           itemsize=g.element_size()))
        _raise_on(fn(*(t.data_ptr() for t in (g, x, s, gx, gs)), *ints,
                     torch.cuda.current_stream().cuda_stream), "mod_backward")

    for dname in dtypes:
        dtype = DTYPES[dname]
        for shape in MOD_SHAPES:
            n, c = shape[:2]
            g = torch.randn(shape, device="cuda").to(dtype)
            x = torch.randn(shape, device="cuda").to(dtype)
            s = (torch.rand((n, c), device="cuda") + 0.5).to(dtype)
            outs = {name: (torch.empty_like(g),
                           torch.empty((n, c), device="cuda"))
                    for name in libs}
            fns = {name: (lambda fn=fn, abi=abi, o=outs[name]:
                          call(fn, abi, g, x, s, *o))
                   for name, (fn, abi) in libs.items()}
            fns["composite"] = lambda: (g * s[:, :, None, None],
                                        (g * x).sum((2, 3), dtype=torch.float32))
            nbytes = 3 * g.numel() * g.element_size() \
                + n * c * (g.element_size() + 4)
            yield {"dtype": dname, "shape": list(shape)}, nbytes, fns, outs
            del g, x, outs


CASES = {"fir_blur": fir_blur_cases, "mod_backward": mod_backward_cases}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("variants", nargs="*", metavar="NAME=SOURCE[@ABI]")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed launches a case (default fir_blur 10, "
                    "mod_backward 25)")
    ap.add_argument("--levels", default="8,16,32,64,128,256,512",
                    help="fir_blur's levels")
    args = ap.parse_args(argv)
    variants = parse_variants(args.kernel, args.variants)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    cold = KERNELS[args.kernel][4]
    reps = args.reps or (10 if cold else 25)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build(args.kernel, variants)
    flush = (torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
             if cold else None)

    def timed(fn):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    sums = {}
    levels = [int(v) for v in args.levels.split(",")]
    for row, nbytes, fns, outs in CASES[args.kernel](
            libs, args.dtypes.split(","), levels):
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        equal = {name: all(torch.equal(a, b) for a, b in zip(o, first))
                 for name, o in outs.items()}
        times = {name: [] for name in fns}
        for _ in range(reps):
            for name, fn in fns.items():
                times[name].append(timed(fn))
        row.update({"bound_ms": 1e3 * nbytes / PEAK_BYTES,
                    "ms": {name: statistics.median(t)
                           for name, t in times.items()},
                    "bitwise_equal_to_first": equal})
        print(json.dumps(row), flush=True)
        prefix = "/".join(str(row[k]) for k in ("dtype", "dir") if k in row)
        for name, ms in list(row["ms"].items()) + [("bound", row["bound_ms"])]:
            sums[f"{prefix}/{name}"] = sums.get(f"{prefix}/{name}", 0.0) + ms
    print(json.dumps({"sums_ms": sums}), flush=True)


if __name__ == "__main__":
    main()
