"""Editing of a BigGAN inversion result (counterpart of the JAX package's
``examples/edit_biggan.py``): the saved ``vars.npy``'s best sample
re-rendered, moved toward another class, and walked along a GANSpace
direction in z.

``--var_path`` is a ``vars.npy`` of an inversion run (either package's);
``--checkpoint`` the weights it ran with (``.npz`` of ``save_params_npz``
or a ``pytorch_pretrained_biggan`` ``.pt`` / ``.pth``; random weights from
seed 0 without it). The GANSpace PCA takes ``--pca_samples`` feature rows
(12,800, the reference's default) and ``--num_components`` (32).
``--smoke`` edits a synthetic result with BigGAN-deep-128, 256 PCA samples
and 4 components. ``--device cpu`` runs on the CPU.

    python -m pix2latent_tpu_torch.examples.edit_biggan \\
        --var_path results/biggan_256/basincma/vars.npy \\
        [--checkpoint WEIGHTS] [--smoke] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import warnings

import numpy as np

from pix2latent_tpu_torch.edit import BigGANLatentEditor, biggan_components
from pix2latent_tpu_torch.utils import image
from pix2latent_tpu_torch.variables import save_variables


def parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--var_path", type=str, default=None,
                   help="vars.npy from an inversion run (required unless "
                        "--smoke)")
    p.add_argument("--smoke", action="store_true",
                   help="offline sanity run: a synthetic inversion result, "
                        "a 128px generator and a tiny PCA")
    p.add_argument("--edit_class", type=int, default=254,
                   help="class index to interpolate toward")
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--component", type=int, default=0)
    p.add_argument("--sigma", type=float, default=2.0)
    p.add_argument("--num_components", type=int, default=32)
    p.add_argument("--pca_samples", type=int, default=12800,
                   help="samples for GANSpace PCA (reference default 12800)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="./results/edits")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    return p


def smoke_result(model, save_dir):
    """A synthetic inversion result of 4 samples at class 153, saved as
    ``smoke_vars.npy`` in ``save_dir``; returns its path."""
    rng = np.random.RandomState(0)
    c = model.get_class_embedding(153).cpu().numpy()
    variables = {"input": {
        "z": rng.randn(4, 128).astype(np.float32),
        "c": np.broadcast_to(c, (4, 128)).astype(np.float32)}}
    path = osp.join(save_dir, "smoke_vars.npy")
    os.makedirs(save_dir, exist_ok=True)
    save_variables(path, variables, extras={"loss": rng.rand(4)})
    return path


def main(argv=None):
    """Write ``original.jpg``, ``class_edit.jpg`` and ``z_edit.jpg`` to
    ``--save_dir``; returns ``(editor, {name: [H, W, 3] render})``."""
    p = parser()
    args = p.parse_args(argv)
    if not args.smoke and args.var_path is None:
        p.error("--var_path is required (or pass --smoke)")

    from pix2latent_tpu_torch.models.biggan import BigGAN
    version = "biggan-deep-128" if args.smoke else "biggan-deep-256"
    with warnings.catch_warnings():
        if not args.checkpoint:
            warnings.simplefilter("ignore")
        model = BigGAN(version, pretrained_path=args.checkpoint,
                       device=args.device)

    if args.smoke:
        if args.var_path is None:
            args.var_path = smoke_result(model, args.save_dir)
        args.pca_samples, args.num_components = 256, 4
        args.component = min(args.component, 3)

    editor = BigGANLatentEditor(model).load_result(args.var_path)
    editor.components = biggan_components(
        model, editor._c, num_components=args.num_components,
        num_samples=args.pca_samples)

    edits = {"original": editor.default(),
             "class_edit": editor.edit_class(args.edit_class,
                                             alpha=args.alpha),
             "z_edit": editor.edit_z(args.component, args.sigma)}
    os.makedirs(args.save_dir, exist_ok=True)
    for name, im in edits.items():
        image.save(osp.join(args.save_dir, f"{name}.jpg"), im)
    print(f"saved edits -> {args.save_dir}")
    return editor, edits


if __name__ == "__main__":
    main()
