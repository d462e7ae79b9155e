"""The two problems the port drives, built with the port, and a profile of
their inner step on the card.

- ``biggan`` (:func:`build`), the flagship of ``bench.py``: invert a smooth
  256x256 ramp through BigGAN-deep-256 under ProjectionLoss (masked L1 + 10 x
  LPIPS-alex), with z searched by CMA (Clamp hook at 2.0, lr 0.05) and the
  class embedding c by Adam (lr 0.01); population 18.
- ``stylegan2-cars`` (:func:`build_stylegan2`), the problem of
  ``bench_stylegan2.py``: the 512x512 ramp through StyleGAN2 LSUN-Cars
  (config-f, channel multiplier 2) under the same loss with the cars border
  mask, z searched by CMA (Normalize + NormalPerturb(0.05) hook, lr 0.05);
  population 22. Both hand-written StyleGAN2 kernels are on by default.
  Its weights use the ``equalized`` random init (see
  :func:`build_stylegan2`).
- ``stylegan2-ffhq``: the same search through StyleGAN2 FFHQ-1024 (config-f,
  18 w layers, 17 noise maps) on the 1024x1024 ramp, without a border mask,
  under the one-card memory recipe of
  ``examples/invert_stylegan2_ffhq_basincma.py``: synthesis blocks at 256 px
  and above recomputed in the backward (``remat_from_res`` 256) and the
  population run in microbatches of 2 (``max_batch_size``); population 22.

Weights are random, from a seed. ``chip_smoke.py`` drives BasinCMA on all
three.

    python -m pix2latent_tpu_torch.utils.flagship [--model biggan]
        [--steps 10] [--out FILE]
    python -m pix2latent_tpu_torch.utils.flagship --memory [--out FILE]
    python -m pix2latent_tpu_torch.utils.flagship --model stylegan2-ffhq
        --drivers 3 [--out FILE]

times the inner step (hooks, forward, backward, Adam) in bfloat16 with CUDA
events, then traces the same steps with torch.profiler and prints one JSON
line: step time, device-busy share, and device time by kernel, largest
first. ``--memory`` measures the FFHQ problem's peak memory instead
(:func:`ffhq_memory`), ``--drivers`` the seconds per generation of
BasinCMA's two drivers (:func:`compare_drivers`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch


def ramp_target(res):
    """bench.py's target, [res, res, 3] in [-1, 1]: a ramp keeps both loss
    terms active."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / (res - 1)
    return np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1) * 2.0 - 1.0


FFHQ_RECIPE = {"remat_from_res": 256, "max_batch_size": 2}


def cars_loss_mask(res=512):
    """The LSUN-Cars border mask (``examples/common.py:cars_loss_mask``):
    content fills the middle 3/4 of the rows of the padded square."""
    m = np.zeros((res, res, 3), np.float32)
    pad = res // 8
    m[pad:res - pad] = 1.0
    return m


def build(dtype=torch.bfloat16, device="cuda", res=256, seed=0):
    """(model, loss_fn, var_manager) of the flagship problem."""
    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager, distribution, hooks
    from pix2latent_tpu_torch.models.biggan import BigGAN

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        model = BigGAN(f"biggan-deep-{res}", dtype=dtype, seed=seed,
                       device=device)
        loss_fn = LF.ProjectionLoss(lpips_net="alex", beta=10.0, dtype=dtype,
                                    device=device)
    target = ramp_target(res)
    vm = VariableManager(seed=seed, device=device)
    vm.register("z", shape=(128,), var_type="input", grad_free=True,
                distribution=distribution.TruncatedNormalModulo(
                    sigma=1.0, trunc=2.0),
                learning_rate=0.05, hook_fn=hooks.Clamp(2.0))
    vm.register("c", shape=(128,), var_type="input", learning_rate=0.01,
                default=np.zeros((128,), np.float32))
    vm.register("target", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=np.ones((res, res, 3), np.float32))
    return model, loss_fn, vm


def build_stylegan2(dtype=torch.bfloat16, device="cuda", seed=0,
                    model="cars", remat_from_res=0):
    """(model, loss_fn, var_manager) of the StyleGAN2 problem of ``model``
    (``"cars"``: 512 px with the border mask, ``"ffhq"``: 1024 px), with
    both hand-written StyleGAN2 kernels on and synthesis blocks from
    ``remat_from_res`` recomputed in the backward.

    The weights are random from ``seed`` with the ``equalized`` scheme of
    ``models/stylegan2.py:_random_init_``: under the JAX package's own
    random init the image does not depend on z, so the search could not
    lower the loss."""
    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager, hooks
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        net = StyleGAN2(model, search="z", dtype=dtype, seed=seed,
                        fused_mod_bwd=True, fir_kernel=True,
                        remat_from_res=remat_from_res, init="equalized",
                        device=device)
        loss_fn = LF.ProjectionLoss(lpips_net="alex", beta=10.0, dtype=dtype,
                                    device=device)
    res = net.im_res
    vm = VariableManager(seed=seed, device=device)
    vm.register("z", shape=(512,), var_type="input", grad_free=True,
                learning_rate=0.05,
                hook_fn=hooks.Compose(hooks.Normalize(),
                                      hooks.NormalPerturb(0.05)))
    vm.register("target", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=ramp_target(res))
    vm.register("weight", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=np.ones((res, res, 3), np.float32))
    if model == "cars":
        vm.register("loss_mask", shape=(res, res, 3), var_type="output",
                    requires_grad=False, default=cars_loss_mask(res))
    return net, loss_fn, vm


def build_ffhq(dtype=torch.bfloat16, device="cuda", seed=0):
    """(model, loss_fn, var_manager) of the StyleGAN2-FFHQ problem, with
    the recipe's ``remat_from_res`` (its ``max_batch_size`` belongs to the
    optimizer: :data:`FFHQ_RECIPE`)."""
    return build_stylegan2(dtype, device, seed, model="ffhq",
                           remat_from_res=FFHQ_RECIPE["remat_from_res"])


# profiler names of the port's hand-written kernels (csrc/*.cu)
HAND_WRITTEN = {
    "sagan_attention": ("fwd_mma_kernel<", "bwd_dq_mma_kernel<",
                        "bwd_dkv_mma_kernel<", "_tf32_kernel"),
    "fir_blur": ("fir_blur_kernel<",),
    "mod_backward": ("mod_backward_kernel<",),
}
# name: (builder, population, max_batch_size)
PROBLEMS = {"biggan": (build, 18, None),
            "stylegan2-cars": (build_stylegan2, 22, None),
            "stylegan2-ffhq": (build_ffhq, 22, FFHQ_RECIPE["max_batch_size"])}


def profile(model="biggan", steps=10, warmup=5):
    """Time and trace ``steps`` inner steps of problem ``model`` after
    ``warmup`` (see module docstring). Device times are sums of each
    kernel's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from pix2latent_tpu_torch.core.step import ExecutionCore

    builder, pop, max_batch_size = PROBLEMS[model]
    net, loss_fn, vm = builder()
    core = ExecutionCore(net, vm, loss_fn, max_batch_size=max_batch_size)
    variables = core._dedupe_outputs(vm.initialize(pop))
    ctx = core.make_ctx(variables)
    variables, opt = core.init_opt_state(variables)

    def run(n):
        return core.grad_steps(variables, opt, vm.generator, n, ctx=ctx)

    torch.cuda.reset_peak_memory_stats()
    run(warmup)
    times = []
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(1)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(steps)
        end.record()
        end.synchronize()
    traced_ms = start.elapsed_time(end)

    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            kernels[evt.key[:160]] = (kernels.get(evt.key[:160], 0.0)
                                      + evt.self_device_time_total / 1e3)
    device_ms = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    hand_written = {
        kernel: sum(ms for name, ms in top
                    if any(p in name for p in patterns)) / steps
        for kernel, patterns in HAND_WRITTEN.items()}
    return {
        "model": model, "population": pop, "max_batch_size": max_batch_size,
        "remat_from_res": getattr(getattr(net, "generator", None),
                                  "remat_from_res", 0),
        "dtype": "bfloat16", "steps": steps,
        "step_ms_median": statistics.median(times), "step_ms": times,
        "traced_ms": traced_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / traced_ms if traced_ms else None,
        "hand_written_ms_per_step": hand_written,
        "kernels_ms_per_step": [[name, ms / steps] for name, ms in top[:25]],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": _smi_line(),
    }


# FFHQ memory configurations: (remat_from_res, max_batch_size)
FFHQ_MEMORY = {"recipe": (256, 2), "remat_only": (256, None),
               "microbatch_only": (0, 2), "neither": (0, None)}


def ffhq_memory(steps=3, warmup=2):
    """Peak device memory and step time of ``steps`` inner steps of the
    FFHQ problem at population 22 in bfloat16, under the recipe, remat
    alone, microbatching alone and neither (:data:`FFHQ_MEMORY`), after
    ``warmup`` steps; a configuration that runs out of memory gives None."""
    from pix2latent_tpu_torch.core.step import ExecutionCore

    out = {}
    for name, (remat, mbs) in FFHQ_MEMORY.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net, loss_fn, vm = build_stylegan2(model="ffhq", remat_from_res=remat)
        core = ExecutionCore(net, vm, loss_fn, max_batch_size=mbs)
        variables = core._dedupe_outputs(vm.initialize(22))
        ctx = core.make_ctx(variables)
        variables, opt = core.init_opt_state(variables)
        entry = {"remat_from_res": remat, "max_batch_size": mbs}
        try:
            core.grad_steps(variables, opt, vm.generator, warmup, ctx=ctx)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.grad_steps(variables, opt, vm.generator, steps, ctx=ctx)
            torch.cuda.synchronize()
            entry["step_seconds"] = (time.perf_counter() - t0) / steps
            entry["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError as e:
            entry["peak_memory_bytes"] = None
            entry["error"] = str(e).splitlines()[0][:200]
        out[name] = entry
        del net, loss_fn, vm, core, variables, ctx, opt
    return {"model": "stylegan2-ffhq", "population": 22, "dtype": "bfloat16",
            "configurations": out,
            "device_total_bytes": torch.cuda.get_device_properties(0)
            .total_memory, "device": torch.cuda.get_device_name(0),
            "nvidia_smi": _smi_line()}


# the order in which compare_drivers runs the two BasinCMA drivers, so that
# a drift of the host's speed during the call falls on both alike
DRIVER_ORDER = ("optimize", "optimize_fused", "optimize_fused", "optimize")


def compare_drivers(model="stylegan2-ffhq", generations=3,
                    deterministic=False):
    """Seconds per generation of ``BasinCMAOptimizer.optimize`` (the host
    loop) and ``optimize_fused`` on problem ``model`` at the same seed, each
    run twice in :data:`DRIVER_ORDER`: ``generations`` generations of 30
    inner steps and no final steps. The first generation of each run is
    left out of its mean. ``max_rel_loss_difference`` compares each run's
    tell losses with the first run's, generation by generation.
    ``deterministic`` asks PyTorch for its deterministic algorithms (cuDNN
    and cuBLAS included; an op that has none still runs, with a warning)."""
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)
    from pix2latent_tpu_torch.optimizers import BasinCMAOptimizer

    builder, pop, max_batch_size = PROBLEMS[model]
    net, loss_fn, vm = builder()
    runs = []
    for driver in DRIVER_ORDER:
        opt = BasinCMAOptimizer(net, vm, loss_fn, seed=0,
                                max_batch_size=max_batch_size)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(opt, driver)(generations, 30, last_grad_steps=0,
                             popsize=pop)
        torch.cuda.synchronize()
        runs.append({"driver": driver, "seconds": time.perf_counter() - t0,
                     "gen_seconds": opt.gen_seconds,
                     "seconds_per_generation":
                         statistics.mean(opt.gen_seconds[1:]),
                     "tell_min_per_generation": list(opt.losses)})
    mean = {d: statistics.mean(r["seconds_per_generation"] for r in runs
                               if r["driver"] == d) for d in DRIVER_ORDER}
    return {"model": model, "population": pop,
            "max_batch_size": max_batch_size, "dtype": "bfloat16",
            "generations": generations, "grad_steps": 30,
            "deterministic": deterministic, "runs": runs,
            "seconds_per_generation": mean,
            "fused_over_host_loop": mean["optimize_fused"] / mean["optimize"],
            "max_rel_loss_difference": max(
                abs(a - b) / abs(b) for r in runs
                for a, b in zip(r["tell_min_per_generation"],
                                runs[0]["tell_min_per_generation"])),
            "device": torch.cuda.get_device_name(0),
            "nvidia_smi": _smi_line()}


def _smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description="profile an inner step")
    ap.add_argument("--model", choices=sorted(PROBLEMS), default="biggan")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--memory", action="store_true",
                    help="instead: the FFHQ problem's peak memory under each "
                         "memory configuration")
    ap.add_argument("--drivers", type=int, default=0, metavar="G",
                    help="instead: time BasinCMA's optimize against "
                         "optimize_fused on --model for G generations")
    ap.add_argument("--deterministic", action="store_true",
                    help="with --drivers: PyTorch's deterministic algorithms")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.memory:
        result = ffhq_memory()
    elif args.drivers:
        if args.deterministic:       # cuBLAS reads it when it starts
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        result = compare_drivers(model=args.model, generations=args.drivers,
                                 deterministic=args.deterministic)
    else:
        result = profile(model=args.model, steps=args.steps)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
