"""Convert a torch checkpoint to a ``.npz`` of parameters (counterpart of the
JAX package's ``scripts/convert.py``, with the same arguments and report):

    python -m pix2latent_tpu_torch.scripts.convert biggan G-256.pt \\
        biggan256.npz --model biggan-deep-256
    python -m pix2latent_tpu_torch.scripts.convert stylegan2 \\
        stylegan2-car-config-f.pt cars.npz --res 512
    python -m pix2latent_tpu_torch.scripts.convert lpips lpips_alex.pt \\
        lpips_alex.npz --net alex

The ``.npz`` has the flat layout of ``save_params_npz``, which both packages
read: pass it as ``pretrained_path=`` (``BigGAN``, ``StyleGAN2``, ``LPIPS``)
or as an example's ``--checkpoint``.
"""

from __future__ import annotations

import argparse
import math

import torch

from pix2latent_tpu_torch.utils.params_io import save_params_npz


def _load_torch(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def convert(kind, sd, *, model="biggan-deep-256", res=512, cm=2, net="alex"):
    """The parameter tree of checkpoint ``sd`` (a state dict, or StyleGAN2's
    ``{"g_ema": ...}``) by the converter of ``kind``."""
    if kind == "biggan":
        from pix2latent_tpu_torch.models.biggan import convert_torch_biggan
        return convert_torch_biggan(sd, model)
    if kind == "stylegan2":
        from pix2latent_tpu_torch.models.stylegan2 import \
            convert_torch_stylegan2
        del cm                  # the converter reads the shapes from sd
        if isinstance(sd, dict) and "g_ema" in sd:
            sd = sd["g_ema"]
        return convert_torch_stylegan2(sd, res)
    if kind == "lpips":
        from pix2latent_tpu_torch.losses.lpips import convert_torch_lpips
        return convert_torch_lpips(sd, net=net)
    raise ValueError(kind)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("kind", choices=["biggan", "stylegan2", "lpips"])
    p.add_argument("checkpoint", help="torch checkpoint (.pt/.pth)")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--model", default="biggan-deep-256",
                   help="biggan: model version")
    p.add_argument("--res", type=int, default=512,
                   help="stylegan2: image resolution (512 cars / 1024 ffhq)")
    p.add_argument("--cm", type=int, default=2,
                   help="stylegan2: channel multiplier")
    p.add_argument("--net", default="alex",
                   choices=["alex", "vgg16", "squeeze"],
                   help="lpips: backbone")
    args = p.parse_args(argv)

    sd = _load_torch(args.checkpoint)
    params = convert(args.kind, sd, model=args.model, res=args.res,
                     cm=args.cm, net=args.net)
    report = save_params_npz(args.out, params)
    total = 0
    for key in sorted(report):
        shape = report[key]
        total += int(math.prod(shape))
        print(f"  {key:70s} {str(tuple(shape)):20s}")
    print(f"wrote {args.out}: {len(report)} arrays, "
          f"{total / 1e6:.2f}M parameters")
    return report


if __name__ == "__main__":
    main()
