"""StyleGAN2 config-f generator (Karras et al., arXiv:1912.04958; the layout
of rosinality's stylegan2-pytorch) in plain PyTorch.

Mapping: pixel norm, ``n_mlp`` equalized linears (lr_mul 0.01) with fused
leaky ReLU. Synthesis: constant input, modulated 3x3 convs with weight
demodulation written as ``conv(x * s) * d`` (the same function as a
per-sample modulated weight), transposed stride-2 convs blurred by the
[1, 3, 3, 1] FIR for upsampling, noise injection, 1x1 ToRGB taps summed
through FIR-upsampled skips. Output ``[n, H, W, 3]``, clamped to [-1, 1].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def channels(cfg, res: int) -> int:
    return cfg["channels"][str(res)]


def noise_resolutions(cfg):
    log = int(math.log2(cfg["im_res"]))
    return [2 ** ((i + 5) // 2) for i in range((log - 2) * 2 + 1)]


def param_shapes(cfg) -> dict:
    """``{name: shape}`` of every weight, named as the port's state_dict."""
    sd = cfg["style_dim"]
    out = {}
    for i in range(cfg["n_mlp"]):
        out[f"generator.style_{i}.weight"] = (sd, sd)
        out[f"generator.style_{i}.bias"] = (sd,)
    for i, r in enumerate(noise_resolutions(cfg)):
        out[f"generator.noise_{i}"] = (1, 1, r, r)
    c4 = channels(cfg, 4)
    out["generator.input"] = (1, c4, 4, 4)

    def modconv(prefix, cin, cout, k):
        out[f"{prefix}.weight"] = (cout, cin, k, k)
        out[f"{prefix}.modulation.weight"] = (cin, sd)
        out[f"{prefix}.modulation.bias"] = (cin,)

    def styled(prefix, cin, cout):
        modconv(f"{prefix}.conv", cin, cout, 3)
        out[f"{prefix}.noise.weight"] = ()
        out[f"{prefix}.bias"] = (cout,)

    def to_rgb(prefix, cin):
        modconv(f"{prefix}.conv", cin, 3, 1)
        out[f"{prefix}.bias"] = (3,)

    styled("generator.conv1", c4, c4)
    to_rgb("generator.to_rgb1", c4)
    ch = c4
    for li in range(int(math.log2(cfg["im_res"])) - 2):
        cout = channels(cfg, 2 ** (li + 3))
        styled(f"generator.convs_{2 * li}", ch, cout)
        styled(f"generator.convs_{2 * li + 1}", cout, cout)
        to_rgb(f"generator.to_rgbs_{li}", cout)
        ch = cout
    return out


def _fir(cfg, gain, dtype, device):
    k = torch.tensor(cfg["blur_kernel"], dtype=torch.float64)
    k = torch.outer(k, k)
    return (k / k.sum() * gain).to(dtype=dtype, device=device)


def upfirdn2d(x, kernel, up=1, pad=(0, 0)):
    """Zero-insertion upsampling by ``up`` (zeros after every sample), zero
    padding by ``pad`` on both axes, then correlation with ``kernel``."""
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h, up, w, up))
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(n, c, h * up, w * up)
    x = F.pad(x, (pad[0], pad[1], pad[0], pad[1]))
    return F.conv2d(x, kernel[None, None].expand(c, 1, *kernel.shape),
                    groups=c)


def fused_leaky_relu(x, bias):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return F.leaky_relu(x + bias.reshape(shape), 0.2) * math.sqrt(2.0)


def _equal_linear(W, prefix, x, lr_mul, activation):
    w = W[f"{prefix}.weight"] * (lr_mul / math.sqrt(x.shape[1]))
    out = x @ w.t()
    bias = W[f"{prefix}.bias"] * lr_mul
    return fused_leaky_relu(out, bias) if activation else out + bias


def modulated_conv(W, prefix, x, w_lat, cfg, demodulate=True, up=False):
    """The modulated conv ``prefix``: ``x [n, cin, H, W]``."""
    weight = W[f"{prefix}.weight"]
    cout, cin, k, _ = weight.shape
    s = _equal_linear(W, f"{prefix}.modulation", w_lat, 1.0, False)
    wt = weight / math.sqrt(cin * k * k)
    xm = x * s[:, :, None, None]
    if up:
        y = F.conv_transpose2d(xm, wt.transpose(0, 1), stride=2)
        p = len(cfg["blur_kernel"]) - 2 - (k - 1)
        y = upfirdn2d(y, _fir(cfg, 4.0, y.dtype, y.device),
                      pad=((p + 1) // 2 + 1, p // 2 + 1))
    else:
        y = F.conv2d(xm, wt, padding=k // 2)
    if demodulate:
        d = torch.rsqrt((s ** 2) @ (wt ** 2).sum(dim=(2, 3)).t() + 1e-8)
        y = y * d[:, :, None, None]
    return y


def _styled(W, prefix, x, w_lat, noise, cfg, up=False):
    y = modulated_conv(W, f"{prefix}.conv", x, w_lat, cfg, up=up)
    y = y + W[f"{prefix}.noise.weight"] * noise
    return fused_leaky_relu(y, W[f"{prefix}.bias"])


def _to_rgb(W, prefix, x, w_lat, cfg, skip=None):
    y = modulated_conv(W, f"{prefix}.conv", x, w_lat, cfg, demodulate=False)
    y = y + W[f"{prefix}.bias"][None, :, None, None]
    if skip is not None:
        up = _fir(cfg, 4.0, skip.dtype, skip.device)
        p = up.shape[0] - 2
        skip = upfirdn2d(skip, up, up=2, pad=((p + 1) // 2 + 1, p // 2))
        y = y + skip
    return y


def mapping(W, z, cfg):
    h = z * torch.rsqrt((z ** 2).mean(dim=-1, keepdim=True) + 1e-8)
    for i in range(cfg["n_mlp"]):
        h = _equal_linear(W, f"generator.style_{i}", h, cfg["lr_mul"], True)
    return h


def generate(W, z, cfg):
    """Images ``[n, H, W, 3]`` in [-1, 1] of ``z [n, 512]`` through the
    mapping network, with the stored noise maps."""
    w_lat = mapping(W, z, cfg)
    noises = [W[f"generator.noise_{i}"]
              for i in range(len(noise_resolutions(cfg)))]
    n = z.shape[0]
    x = W["generator.input"].expand(n, -1, -1, -1)
    x = _styled(W, "generator.conv1", x, w_lat, noises[0], cfg)
    skip = _to_rgb(W, "generator.to_rgb1", x, w_lat, cfg)
    for li in range(int(math.log2(cfg["im_res"])) - 2):
        x = _styled(W, f"generator.convs_{2 * li}", x, w_lat,
                    noises[2 * li + 1], cfg, up=True)
        x = _styled(W, f"generator.convs_{2 * li + 1}", x, w_lat,
                    noises[2 * li + 2], cfg)
        skip = _to_rgb(W, f"generator.to_rgbs_{li}", x, w_lat, cfg, skip)
    return skip.clamp(-1.0, 1.0).permute(0, 2, 3, 1)
