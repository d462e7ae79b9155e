#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--generations G] [--final-steps F]

Phases, one JSON line each; any failure raises and exits non-zero:

1. ``env``: torch and CUDA versions, the card's name and power limit.
2. ``build``: every CUDA source under ``pix2latent_tpu_torch/csrc`` built
   with one ``nvcc`` each, all started together.
3. ``kernels``: the SA-GAN attention kernel, forward and backward, against
   its plain PyTorch version on the card, in float32 and bfloat16, at the
   BigGAN-deep-256 shape the main path gives it and at a small ragged shape,
   with the tolerances of ``tests/test_attention.py``. Times (CUDA events,
   median of 25 runs) of the kernel, the plain version and one PyTorch call
   computing the same function (``scaled_dot_product_attention`` with
   ``scale=1.0``, timed here only and never called by the port), beside the
   least time the card could take.
4. ``main_path``: BasinCMA inversion of the ``bench.py`` ramp target through
   BigGAN-deep-256 at full width (channel width 128) in bfloat16, under
   ProjectionLoss (masked L1 + 10 x LPIPS-alex), population 18, 30 inner
   Adam steps per generation, random weights from a seed. The launch
   counters are set to 0 just before and read just after; they must equal
   one forward per inner step and per tell, one backward per inner step.
5. ``whole_step``: one float32 forward and backward of generator + loss at
   population 2 and full width, on the card against the CPU.

Then the ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line and the
result line. It exits non-zero, printing no result, without a CUDA device or
without the package beside it.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores and f32
# outside them (the kernel uses no TF32), and HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

FLAGSHIP = (18, 4096, 1024, 64, 256)   # n, q, k, d, dv at 256 px, pop 18
RAGGED = (3, 100, 37, 5, 20)
# (atol = rtol) for the output and for the gradients, tests/test_attention.py
TOL = {"float32": (1e-5, 2e-4), "bfloat16": (2e-2, 5e-2)}
POP, GRAD_STEPS = 18, 30


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=25, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err_within(a, b, tol):
    """(max |a - b|, whether |a - b| <= tol + tol * |b| everywhere)."""
    a, b = a.detach().float(), b.detach().float()
    diff = (a - b).abs()
    return float(diff.max()), bool((diff <= tol + tol * b.abs()).all())


def phase_env():
    import torch
    info = {"phase": "env", "python": sys.version.split()[0],
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(), "nvidia_smi": smi_line()}
    emit(info)
    return info


def phase_build():
    from pix2latent_tpu_torch.utils.cuda_build import all_sources, build
    t0 = time.perf_counter()
    report = build(all_sources())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": report})


def _attention_case(shape, dtype, timed):
    import torch
    import torch.nn.functional as F
    from pix2latent_tpu_torch.ops import attention as A

    n, q, k, d, dv = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def mk(*s):
        return (0.5 * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    theta, phi, g, cot = mk(n, q, d), mk(n, k, d), mk(n, k, dv), mk(n, q, dv)
    ins_k = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_k = A.sagan_attention(*ins_k)
    grads_k = torch.autograd.grad(out_k, ins_k, cot)
    ins_r = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_r = A.sagan_attention_reference(*ins_r)
    grads_r = torch.autograd.grad(out_r, ins_r, cot, retain_graph=True)
    torch.cuda.synchronize()

    name = str(dtype).replace("torch.", "")
    tol_o, tol_g = TOL[name]
    err_o, ok_o = max_err_within(out_k, out_r, tol_o)
    errs_g = [max_err_within(a, b, tol_g) for a, b in zip(grads_k, grads_r)]
    case = {"shape": list(shape), "dtype": name, "tol_out": tol_o,
            "tol_grad": tol_g, "fwd_max_abs_err": err_o,
            "bwd_max_abs_err": max(e for e, _ in errs_g),
            "ok": ok_o and all(ok for _, ok in errs_g)}
    if not timed:
        return case

    o, m, l = A.kernel_forward(theta, phi, g)
    case["fwd_ms"] = cuda_ms(lambda: A.kernel_forward(theta, phi, g))
    case["bwd_ms"] = cuda_ms(
        lambda: A.kernel_backward(theta, phi, g, cot, m, l))
    case["plain_fwd_ms"] = cuda_ms(
        lambda: A.sagan_attention_reference(theta, phi, g))
    case["plain_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out_r, ins_r, cot, retain_graph=True))
    case["library_fwd_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(theta, phi, g, scale=1.0))
    ins_l = [t.clone().requires_grad_(True) for t in (theta, phi, g)]
    out_l = F.scaled_dot_product_attention(*ins_l, scale=1.0)
    case["library_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out_l, ins_l, cot, retain_graph=True))

    # each input read once, each output written once; the f32 row
    # statistics (m, l) are an output of the forward and an input of the
    # backward
    size = 2 if dtype == torch.bfloat16 else 4
    stats = 2 * 4 * n * q
    bytes_fwd = size * (n * q * d + n * k * d + n * k * dv + n * q * dv) \
        + stats
    bytes_bwd = size * 2 * (n * q * d + n * k * d + n * k * dv) \
        + size * n * q * dv + stats
    ops_fwd = 2 * n * q * k * (d + dv)
    ops_bwd = 2 * n * q * k * (3 * d + 2 * dv)
    for key, b, f in (("fwd", bytes_fwd, ops_fwd), ("bwd", bytes_bwd, ops_bwd)):
        t_bytes, t_ops = b / PEAK_BYTES, f / PEAK_FLOPS[name]
        case[f"{key}_bound_ms"] = 1e3 * max(t_bytes, t_ops)
        case[f"{key}_bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        case[f"{key}_bytes"], case[f"{key}_ops"] = b, f
    del o
    return case


def phase_kernels():
    import torch
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases.append(_attention_case(FLAGSHIP, dtype, timed=True))
        cases.append(_attention_case(RAGGED, dtype, timed=False))
        torch.cuda.empty_cache()
    emit({"phase": "kernels",
          "kernels": ["sagan_attention_fwd", "sagan_attention_bwd"],
          "cases": cases})
    bad = [c for c in cases if not c["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return cases


def phase_main_path(generations, final_steps):
    import math

    import torch
    from pix2latent_tpu_torch.ops import attention as A
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer
    from pix2latent_tpu_torch.utils.flagship import build

    model, loss_fn, vm = build(torch.bfloat16, "cuda")
    opt = BasinCMAOptimizer(model, vm, loss_fn, seed=0, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    A.reset_launch_counts()
    t0 = time.perf_counter()
    variables, outs, final = opt.optimize(generations, GRAD_STEPS,
                                          last_grad_steps=final_steps)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = A.launch_counts()

    out = outs[0]
    tell_mins = opt.losses
    final_min = float(final[0][1]["loss"].min())
    expect = {"fwd": generations * (GRAD_STEPS + 1) + final_steps,
              "bwd": generations * GRAD_STEPS + final_steps}
    steady = opt.gen_seconds[1:] or opt.gen_seconds
    gen_s = statistics.mean(steady)
    result = {
        "phase": "main_path", "model": "biggan-deep-256", "channel_width": 128,
        "dtype": "bfloat16", "population": opt.num_samples,
        "grad_steps": GRAD_STEPS, "generations": generations,
        "final_steps": final_steps,
        "shortened": ("no" if (generations, final_steps) == (30, 300) else
                      f"{generations} of 30 generations, {final_steps} of "
                      "300 final Adam steps"),
        "seconds": seconds, "gen_seconds": opt.gen_seconds,
        "seconds_per_generation": gen_s,
        "images_per_sec": opt.num_samples * GRAD_STEPS / gen_s,
        "tell_min_per_generation": tell_mins, "final_min_loss": final_min,
        "out_shape": list(out.shape),
        "attention_launches": counts, "expected_launches": expect,
        "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(result)
    assert opt.num_samples == POP, opt.num_samples
    assert tuple(out.shape) == (POP, 256, 256, 3), out.shape
    assert all(math.isfinite(v) for v in tell_mins), tell_mins
    assert math.isfinite(final_min) and final_min < tell_mins[0], (
        f"no convergence: first generation {tell_mins[0]}, final {final_min}")
    assert counts == expect, (counts, expect)
    assert counts["fwd"] > 0 and counts["bwd"] > 0
    return counts


def phase_whole_step():
    import torch
    from pix2latent_tpu_torch.core.step import ExecutionCore
    from pix2latent_tpu_torch.utils.flagship import build

    def step(device):
        model, loss_fn, vm = build(torch.float32, device)
        core = ExecutionCore(model, vm, loss_fn)
        gen = torch.Generator(device="cpu")
        gen.manual_seed(1)
        z = torch.fmod(torch.randn(2, 128, generator=gen), 2.0)
        c = 0.1 * torch.randn(2, 128, generator=gen)
        variables = vm.initialize(2)
        variables["input"] = {"z": z.to(device).requires_grad_(True),
                              "c": c.to(device).requires_grad_(True)}
        variables = core._dedupe_outputs(variables)
        loss, per_sample, out = core._forward_loss(variables,
                                                   core.make_ctx(variables))
        loss.backward()
        return (per_sample.detach().cpu().double(),
                variables["input"]["z"].grad.cpu().double(),
                variables["input"]["c"].grad.cpu().double())

    tol = 1e-3
    card, cpu = step("cuda"), step("cpu")
    rel = {name: float((a - b).norm() / b.norm().clamp_min(1e-30))
           for name, a, b in zip(("loss", "dz", "dc"), card, cpu)}
    result = {"phase": "whole_step", "dtype": "float32", "population": 2,
              "rel_err": rel, "tolerance": tol,
              "loss": card[0].tolist(), "grad_norms": {
                  "dz": float(card[1].norm()), "dc": float(card[2].norm())}}
    emit(result)
    assert all(v <= tol for v in rel.values()), rel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generations", type=int, default=30)
    ap.add_argument("--final-steps", type=int, default=300)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "pix2latent_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the pix2latent_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    env = phase_env()
    phase_build()
    cases = phase_kernels()
    counts = phase_main_path(args.generations, args.final_steps)
    phase_whole_step()

    flag = next(c for c in cases
                if c["dtype"] == "bfloat16" and tuple(c["shape"]) == FLAGSHIP)
    src = "pix2latent_tpu_torch/csrc/sagan_attention.cu"
    kernels = []
    for key, line in (("fwd", 131), ("bwd", 154)):
        kernels.append({
            "name": f"sagan_attention_{key}", "route": "cuda", "source": src,
            "replaces": f"pix2latent_tpu/ops/attention.py:{line}",
            "launches": counts[key],
            "max_abs_err": flag[f"{key}_max_abs_err"],
            "ms": flag[f"{key}_ms"], "plain_ms": flag[f"plain_{key}_ms"],
            "bound_ms": flag[f"{key}_bound_ms"],
            "bound_by": flag[f"{key}_bound_by"],
            "library_ms": flag[f"library_{key}_ms"]})
    emit({"kernels": kernels})
    print(env["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
