"""The flagship problem of ``bench.py``, built with the port, and a profile
of its inner step on the card.

The problem: invert a smooth 256x256 ramp through BigGAN-deep-256 under
ProjectionLoss (masked L1 + 10 x LPIPS-alex), with z searched by CMA (Clamp
hook at 2.0, lr 0.05) and the class embedding c by Adam (lr 0.01), random
weights from a seed. ``chip_smoke.py`` drives BasinCMA on it.

    python -m pix2latent_tpu_torch.utils.flagship [--steps 10] [--out FILE]

times the inner step (hooks, forward, backward, Adam) at population 18 in
bfloat16 with CUDA events, then traces the same steps with torch.profiler
and prints one JSON line: step time, device-busy share, and device time by
kernel, largest first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import warnings

import numpy as np
import torch


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
    # bench.py's target: a ramp keeps both loss terms active
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / (res - 1)
    target = np.stack([xx, yy, 0.5 * (xx + yy)], axis=-1) * 2.0 - 1.0
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


def profile(steps=10, warmup=5, pop=18):
    """Time and trace ``steps`` inner steps after ``warmup`` (see module
    docstring). Device times are sums of each kernel's own time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from pix2latent_tpu_torch.core.step import ExecutionCore

    model, loss_fn, vm = build()
    core = ExecutionCore(model, vm, loss_fn)
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
    attention = sum(ms for name, ms in top if "sagan" in name or any(
        k in name for k in ("fwd_kernel<", "bwd_dq_kernel<",
                            "bwd_dkv_kernel<")))
    return {
        "population": pop, "dtype": "bfloat16", "steps": steps,
        "step_ms_median": statistics.median(times), "step_ms": times,
        "traced_ms": traced_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / traced_ms if traced_ms else None,
        "attention_ms_per_step": attention / steps,
        "kernels_ms_per_step": [[name, ms / steps] for name, ms in top[:25]],
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description="profile the flagship inner step")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    result = profile(steps=args.steps)
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
