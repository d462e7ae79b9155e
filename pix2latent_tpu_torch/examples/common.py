"""Shared example harness (counterpart of the JAX package's
``examples/common.py``): the argument parser, model and target loading, the
canonical variable registration, the loss and the result file.

Every example runs offline: random weights from a seed unless
``--checkpoint`` names a converted ``.npz`` (for BigGAN also a
``pytorch_pretrained_biggan`` ``.pt`` / ``.pth``, for StyleGAN2 a
rosinality ``g_ema`` checkpoint), and a synthetic self-generated target
unless ``--fp`` names an image (``--mask_fp`` its weight). PNG needs no
imaging library; other formats and a resize need PIL; ``--make_video``
needs cv2 or imageio (``utils/image.py``, ``utils/video.py``).
"""

from __future__ import annotations

import argparse
import os.path as osp
import warnings

import numpy as np
import torch

import pix2latent_tpu_torch.loss_functions as LF
from pix2latent_tpu_torch import distribution as dist
from pix2latent_tpu_torch import hooks
from pix2latent_tpu_torch.utils import image
from pix2latent_tpu_torch.utils.misc import to_numpy
from pix2latent_tpu_torch.utils.project_utils import save_result


def base_parser(desc, model="biggan"):
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--fp", type=str, default=None,
                   help="target image path (synthetic target if omitted)")
    p.add_argument("--mask_fp", type=str, default=None,
                   help="mask image path: the loss weight, 1 on the object")
    p.add_argument("--class_lbl", type=int, default=153)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--latent_noise", type=float, default=0.05)
    p.add_argument("--truncate", type=float, default=2.0)
    p.add_argument("--make_video", action="store_true",
                   help="log frames and write them as out.mp4")
    p.add_argument("--num_samples", type=int, default=9)
    p.add_argument("--max_minibatch", type=int, default=None,
                   help="population microbatch size: bounds peak activation "
                        "memory by running the population in chunks (the "
                        "FFHQ-1024 x pop-22 recipe uses 2); None runs the "
                        "population whole")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="pretrained weights: a converted .npz, or a torch "
                        "checkpoint (BigGAN: pytorch_pretrained_biggan "
                        ".pt/.pth; StyleGAN2: rosinality)")
    p.add_argument("--save_dir", type=str, default=None)
    p.add_argument("--smoke", action="store_true",
                   help="tiny budgets for a fast sanity run")
    p.add_argument("--active_cma", action="store_true",
                   help="aCMA negative-weight covariance updates")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    if model == "stylegan2":
        p.add_argument("--model", type=str, default="cars",
                       choices=["cars", "ffhq"])
        p.add_argument("--search", type=str, default="z",
                       choices=["z", "w+"])
        p.add_argument("--bf16", action="store_true",
                       help="bfloat16 generator compute")
        p.add_argument("--remat_from_res", type=int, default=0,
                       help="recompute synthesis blocks >= this resolution "
                            "in the backward pass (FFHQ-1024 recipe: "
                            "--bf16 --remat_from_res 256 --max_minibatch 2)")
    return p


def load_biggan(args):
    """BigGAN-deep-256 as the JAX package's ``load_biggan`` builds it: float32
    (no bf16 flag for BigGAN), so its SA-GAN attention takes the kernel's
    float32 route. ``--checkpoint``: a ``.npz`` of ``save_params_npz`` or a
    ``pytorch_pretrained_biggan`` ``.pt`` / ``.pth``; anything else raises
    ``ValueError``."""
    from pix2latent_tpu_torch.models.biggan import BigGAN
    with warnings.catch_warnings():
        if args.checkpoint:
            return BigGAN("biggan-deep-256", pretrained_path=args.checkpoint,
                          device=args.device)
        warnings.simplefilter("ignore")
        return BigGAN("biggan-deep-256", device=args.device)


def load_stylegan2(args):
    """StyleGAN2 as the JAX package's ``load_stylegan2`` builds it, with the
    hand-written kernels on the card: on a CUDA ``--device`` the FIR blur
    (K2, ``fir_kernel``) and the fused modulation backward (K3,
    ``fused_mod_bwd``) are on, the counterparts of the JAX package's Pallas
    kernels, which it leaves off only because they need a TPU; on the CPU
    both stay off and the plain PyTorch paths run. ``pack_pairs_max_ch``
    stays 0."""
    from pix2latent_tpu_torch.models.stylegan2 import StyleGAN2
    on_card = torch.device(args.device).type == "cuda"
    kwargs = dict(
        search=args.search,
        dtype=torch.bfloat16 if getattr(args, "bf16", False) else torch.float32,
        remat_from_res=getattr(args, "remat_from_res", 0),
        fused_mod_bwd=on_card, fir_kernel=on_card, device=args.device)
    with warnings.catch_warnings():
        if args.checkpoint:
            return StyleGAN2(args.model, pretrained_path=args.checkpoint,
                             **kwargs)
        warnings.simplefilter("ignore")
        return StyleGAN2(args.model, **kwargs)


def load_target(args, model, style=None):
    """Target and weight, ``[im, im, 3]`` in [-1, 1] on ``args.device``.

    With ``--fp`` the image, read at the model's resolution: for BigGAN the
    short side resized and center-cropped, for StyleGAN2 padded to a square
    and resized (``style`` overrides). Without it the synthetic
    self-generated target: for BigGAN the image of a z of 128 and the class
    embedding of ``--class_lbl``, for StyleGAN2 of a z of 512 through the z
    path even in w+ search; z is drawn from a torch generator seeded 1, so
    the target differs from the JAX package's (whose z comes from
    ``PRNGKey(1)``). The weight is ``--mask_fp`` read the same way, taken
    to [0.3, 1], or ones."""
    is_biggan = hasattr(model, "get_class_embedding")
    if style is None:
        style = "biggan" if is_biggan else "stylegan2"
    im_size = model.im_res
    if args.fp:
        target = image.read(args.fp, im_size=im_size, transform_style=style,
                            device=model.device)
    else:
        print("no --fp given: using a synthetic self-generated target")
        gen = torch.Generator(device=model.device).manual_seed(1)
        with torch.no_grad():
            if is_biggan:
                z = torch.randn((1, 128), generator=gen, device=model.device)
                target = model(z, model.get_class_embedding(args.class_lbl))[0]
            else:
                z = torch.randn((1, 512), generator=gen, device=model.device)
                target = model.generator(z).clamp(-1.0, 1.0).permute(
                    0, 2, 3, 1)[0]
    if args.mask_fp:
        weight = image.read(args.mask_fp, im_size=im_size,
                            transform_style=style, device=model.device)
        weight = torch.clamp((weight + 1.0) / 2.0, 0.3, 1.0)
    else:
        weight = torch.ones_like(target)
    return target, weight


def register_biggan_vars(vm, model, args, target, weight):
    """The canonical BigGAN registration: z folded into the truncation by
    its distribution and clamped by its hook, c at lr 0.01 from the class
    embedding of ``--class_lbl``, and the target and weight."""
    im = target.shape[0]
    vm.register("z", shape=(128,), var_type="input",
                grad_free=getattr(args, "grad_free", False),
                distribution=dist.TruncatedNormalModulo(
                    sigma=1.0, trunc=args.truncate),
                learning_rate=args.lr, hook_fn=hooks.Clamp(args.truncate))
    vm.register("c", shape=(128,), var_type="input", learning_rate=0.01,
                default=model.get_class_embedding(args.class_lbl)[0])
    vm.register("target", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=weight)
    return vm


def register_stylegan2_vars(vm, model, args, target, weight, loss_mask=None):
    """The canonical StyleGAN2 registration. ``--search w+`` searches the w
    latent, started at the mean latent without the Normalize hook, plus the
    flattened per-layer noise vector as an Adam-only variable."""
    im = target.shape[0]
    if getattr(args, "search", "z") == "w+":
        w_mean, w_std = model.latent_stats()
        # sigma floor: a random-init mapping network collapses w
        w_sigma = max(0.1 * float(w_std), 0.05)
        gf = getattr(args, "grad_free", False)
        if gf is True:
            gf = (to_numpy(w_mean), w_sigma)
        vm.register("z", shape=(512,), var_type="input", grad_free=gf,
                    distribution=dist.Normal(mu=w_mean, sigma=w_sigma),
                    learning_rate=args.lr,
                    hook_fn=hooks.NormalPerturb(args.latent_noise))
        vm.register("noises", shape=(model.noise_dim(),), var_type="input",
                    learning_rate=0.01,
                    default=np.zeros((model.noise_dim(),), np.float32))
    else:
        vm.register("z", shape=(512,), var_type="input",
                    grad_free=getattr(args, "grad_free", False),
                    distribution=dist.Normal(sigma=1.0),
                    learning_rate=args.lr,
                    hook_fn=hooks.Compose(
                        hooks.Normalize(),
                        hooks.NormalPerturb(args.latent_noise)))
    vm.register("target", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=target)
    vm.register("weight", shape=(im, im, 3), var_type="output",
                requires_grad=False, default=weight)
    if loss_mask is not None:
        vm.register("loss_mask", shape=(im, im, 3), var_type="output",
                    requires_grad=False, default=loss_mask)
    return vm


def cars_loss_mask(im=512, model="cars"):
    """LSUN-Cars border mask: content fills the middle 3/4 of the rows of
    the padded square. None for the other models (FFHQ fills the frame)."""
    if model != "cars":
        return None
    m = np.zeros((im, im, 3), np.float32)
    pad = im // 8
    m[pad:im - pad] = 1.0
    return m


def stylegan2_problem(args):
    """``(model, var_manager)`` of the StyleGAN2 entry points:
    :func:`load_stylegan2`, the target and weight of :func:`load_target`,
    and :func:`register_stylegan2_vars` with the cars border mask for
    ``--model cars``."""
    from pix2latent_tpu_torch import VariableManager
    model = load_stylegan2(args)
    target, weight = load_target(args, model)
    vm = register_stylegan2_vars(
        VariableManager(device=args.device), model, args, target, weight,
        loss_mask=cars_loss_mask(model.im_res, args.model))
    return model, vm


def make_loss(args, net="alex"):
    """ProjectionLoss: masked L1 + 10 x LPIPS (``net``: alex, vgg16 or
    squeeze)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return LF.ProjectionLoss(lpips_net=net, beta=10.0, device=args.device)


def finish(args, opt, variables, outs, losses, default_dir):
    """Write the run's results to the save directory and return it: the
    bundle of ``utils/project_utils.save_result`` (``vars.npy``,
    ``losses.npy``, ``out.jpg``, ``best.jpg``, and with ``--make_video``
    ``out.mp4``), and ``result.npz``: every variable as
    ``variables/<type>/<name>``, the last logged loss (``loss``, at step
    ``loss_step``), each generation's min tell loss (``tell_min``, when the
    driver recorded them) and the tracked variables (``tracked/<name>``)."""
    save_dir = args.save_dir or default_dir
    step, final = losses[-1]
    loss = np.asarray(to_numpy(final["loss"]))
    save_result(save_dir, variables, outs, losses, out_images=opt.out,
                make_video=args.make_video)
    payload = {f"variables/{vt}/{name}": to_numpy(t)
               for vt, d in variables.items() for name, t in d.items()}
    payload["loss"] = loss
    payload["loss_step"] = np.int64(step)
    if opt.losses and not isinstance(opt.losses[0], list):
        payload["tell_min"] = np.asarray(opt.losses, np.float64)
    for name, arr in (getattr(opt, "tracked", None) or {}).items():
        payload[f"tracked/{name}"] = np.asarray(arr)
    path = osp.join(save_dir, "result.npz")
    np.savez(path, **payload)
    print(f"done: best loss {payload['loss'].min():.4f} -> {save_dir}")
    return save_dir
