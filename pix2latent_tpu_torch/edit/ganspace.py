"""GANSpace principal directions of BigGAN's first layer (counterpart of
``pix2latent_tpu/edit/ganspace.py``; Härkönen et al., "GANSpace:
Discovering Interpretable GAN Controls", arXiv:2004.02546): the features
``gen_z(concat(z, c))`` of many random ``z`` at a fixed class, their
principal components, and the z-space directions that produce them, solved
in closed form by least squares.

The PCA is the JAX package's randomized range finder (Halko et al. 2011):
``q + oversample`` Gaussian columns and ``niter`` QR subspace iterations.
``torch.pca_lowrank`` takes ``q`` columns, so its subspace differs; it is
not used. Every draw comes from an explicit ``torch.Generator`` through
:func:`_draw`, and everything runs on the model's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _draw(generator, shape, device):
    """Standard normal float32 ``shape`` from ``generator``."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _generator(generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def pca_lowrank(a, q=32, generator=None, oversample=6, niter=2):
    """Randomized PCA of the centered ``a`` ``[n, d]``: ``(s [q], v [d,
    q])``, its top ``q`` singular values and right singular vectors."""
    generator = _generator(generator, a.device)
    a0 = a - a.mean(dim=0, keepdim=True)
    g = _draw(generator, (a.shape[1], q + oversample), a.device).to(a.dtype)
    qmat, _ = torch.linalg.qr(a0 @ g)                   # [n, q + p]
    for _ in range(niter):
        z, _ = torch.linalg.qr(a0.T @ qmat)             # [d, q + p]
        qmat, _ = torch.linalg.qr(a0 @ z)
    _, s, vt = torch.linalg.svd(qmat.T @ a0, full_matrices=False)
    return s[:q], vt[:q].T


def biggan_components(model, class_lbl, num_components=32, num_samples=12800,
                      feat_size=128, generator=None, batch=1024):
    """z-space principal directions of ``model`` (the port's ``BigGAN``) at
    the class ``class_lbl`` (an int, or a class embedding ``[1, 128]``):
    ``[num_components, feat_size]``, rows unit-norm, on the model's device.

    The features are ``F.linear`` through the generator's ``gen_z`` weight
    and bias in float32, ``batch`` samples at a time: at the defaults a
    ``[12800, 32768]`` matrix (1.68 GB). The least-squares solve uses the
    QR driver ``gels`` on every device (the only one on CUDA), which
    assumes a full-rank system: a rank-deficient one raises."""
    device = model.device
    generator = _generator(generator, device)
    with torch.no_grad():
        if isinstance(class_lbl, int):
            c = model.get_class_embedding(class_lbl)
        else:
            c = torch.as_tensor(class_lbl, dtype=torch.float32,
                                device=device).reshape(1, -1)
        z = _draw(generator, (num_samples, feat_size), device)
        gen_z = model.generator.gen_z
        feat = torch.cat([
            F.linear(torch.cat([zb, c.expand(zb.shape[0], -1)], dim=1),
                     gen_z.weight.float(), gen_z.bias.float())
            for zb in z.split(batch)])

        _, v = pca_lowrank(feat, q=num_components, generator=generator)
        x = (feat - feat.mean(dim=0, keepdim=True)) @ v          # [n, q]
        rank = int(torch.linalg.matrix_rank(x))
        if rank < num_components:
            raise RuntimeError(
                f"GANSpace: the projected features have rank {rank} < "
                f"{num_components}; the least-squares solve needs full rank")
        u = torch.linalg.lstsq(x, z, driver="gels").solution    # [q, feat]
        return u / u.norm(dim=1, keepdim=True)
