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

Weights are random, from a seed. ``chip_smoke.py`` drives BasinCMA on both.

    python -m pix2latent_tpu_torch.utils.flagship [--model biggan]
        [--steps 10] [--out FILE]

times the inner step (hooks, forward, backward, Adam) in bfloat16 with CUDA
events, then traces the same steps with torch.profiler and prints one JSON
line: step time, device-busy share, and device time by kernel, largest
first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import warnings

import numpy as np
import torch


def ramp_target(res):
    """bench.py's target, [res, res, 3] in [-1, 1]: a ramp keeps both loss
    terms active."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / (res - 1)
    return np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1) * 2.0 - 1.0


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


def build_stylegan2(dtype=torch.bfloat16, device="cuda", seed=0):
    """(model, loss_fn, var_manager) of the StyleGAN2-cars problem, with
    both hand-written StyleGAN2 kernels on.

    The weights are random from ``seed`` with the ``equalized`` scheme of
    ``models/stylegan2.py:_random_init_``: under the JAX package's own
    random init the image does not depend on z, so the search could not
    lower the loss."""
    import pix2latent_tpu_torch.loss_functions as LF
    from pix2latent_tpu_torch import VariableManager, hooks
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # random-init notices
        model = StyleGAN2("cars", search="z", dtype=dtype, seed=seed,
                          fused_mod_bwd=True, fir_kernel=True,
                          init="equalized", device=device)
        loss_fn = LF.ProjectionLoss(lpips_net="alex", beta=10.0, dtype=dtype,
                                    device=device)
    res = model.im_res
    vm = VariableManager(seed=seed, device=device)
    vm.register("z", shape=(512,), var_type="input", grad_free=True,
                learning_rate=0.05,
                hook_fn=hooks.Compose(hooks.Normalize(),
                                      hooks.NormalPerturb(0.05)))
    vm.register("target", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=ramp_target(res))
    vm.register("weight", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=np.ones((res, res, 3), np.float32))
    vm.register("loss_mask", shape=(res, res, 3), var_type="output",
                requires_grad=False, default=cars_loss_mask(res))
    return model, loss_fn, vm


# profiler names of the port's hand-written kernels (csrc/*.cu)
HAND_WRITTEN = {
    "sagan_attention": ("fwd_mma_kernel<", "bwd_dq_mma_kernel<",
                        "bwd_dkv_mma_kernel<", "::fwd_kernel<",
                        "bwd_dq_kernel<", "bwd_dkv_kernel<"),
    "fir_blur": ("fir_blur_kernel<",),
    "mod_backward": ("mod_backward_kernel<",),
}
PROBLEMS = {"biggan": (build, 18), "stylegan2-cars": (build_stylegan2, 22)}


def profile(model="biggan", steps=10, warmup=5):
    """Time and trace ``steps`` inner steps of problem ``model`` after
    ``warmup`` (see module docstring). Device times are sums of each
    kernel's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from pix2latent_tpu_torch.core.step import ExecutionCore

    builder, pop = PROBLEMS[model]
    net, loss_fn, vm = builder()
    core = ExecutionCore(net, vm, loss_fn)
    variables = core._dedupe_outputs(vm.initialize(pop))
    ctx = core.make_ctx(variables)
    variables, opt = core.init_opt_state(variables)

    def run(n):
        return core.grad_steps(variables, opt, vm.generator, n, ctx=ctx)

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
        "model": model, "population": pop, "dtype": "bfloat16", "steps": steps,
        "step_ms_median": statistics.median(times), "step_ms": times,
        "traced_ms": traced_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / traced_ms if traced_ms else None,
        "hand_written_ms_per_step": hand_written,
        "kernels_ms_per_step": [[name, ms / steps] for name, ms in top[:25]],
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="profile an inner step")
    ap.add_argument("--model", choices=sorted(PROBLEMS), default="biggan")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    result = profile(model=args.model, steps=args.steps)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
