"""BigGAN-deep generator (Brock et al., arXiv:1809.11096; the layout of the
public ``pytorch_pretrained_biggan`` configs) in plain PyTorch.

``z`` and the class embedding ``c`` (``[n, 128]`` each) are concatenated
into the condition of every BatchNorm; bottleneck residual blocks with
nearest-neighbour upsampling and channel-truncation skips; one SA-GAN
non-local block (no 1/sqrt(d) scale, 2x2 max-pooled keys and values, scalar
gamma); BatchNorm over standing statistics interpolated by truncation with
``pytorch_pretrained_biggan``'s reversed lerp; 3 of the output conv's
channels, tanh, NHWC out.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def param_shapes(cfg) -> dict:
    """``{name: shape}`` of every weight, named as the port's state_dict."""
    ch, zc = cfg["channel_width"], cfg["z_dim"] + cfg["class_embed_dim"]
    ns = cfg["n_stats"]
    out = {"generator.gen_z.weight": (16 * 4 * 4 * ch, zc),
           "generator.gen_z.bias": (16 * 4 * 4 * ch,)}

    def bn(prefix, c, conditional=True):
        out[f"{prefix}.running_means"] = (ns, c)
        out[f"{prefix}.running_vars"] = (ns, c)
        if conditional:
            out[f"{prefix}.scale.weight"] = (c, zc)
            out[f"{prefix}.offset.weight"] = (c, zc)
        else:
            out[f"{prefix}.weight"] = (c,)
            out[f"{prefix}.bias"] = (c,)

    for i, (_, in_mult, out_mult) in enumerate(cfg["layers"]):
        cin, cout = in_mult * ch, out_mult * ch
        if i == cfg["attention_position"]:
            a = f"generator.attn_{i}"
            out[f"{a}.theta.weight"] = (cin // 8, cin, 1, 1)
            out[f"{a}.phi.weight"] = (cin // 8, cin, 1, 1)
            out[f"{a}.g.weight"] = (cin // 2, cin, 1, 1)
            out[f"{a}.o_conv.weight"] = (cin, cin // 2, 1, 1)
            out[f"{a}.gamma"] = ()
        b, mid = f"generator.block_{i}", cin // 4
        for j, (ci, co, k) in enumerate(((cin, mid, 1), (mid, mid, 3),
                                         (mid, mid, 3), (mid, cout, 1))):
            bn(f"{b}.bn_{j}", ci)
            out[f"{b}.conv_{j}.weight"] = (co, ci, k, k)
            out[f"{b}.conv_{j}.bias"] = (co,)
    bn("generator.bn_out", cfg["layers"][-1][2] * ch, conditional=False)
    out["generator.conv_to_rgb.weight"] = (ch, ch, 3, 3)
    out["generator.conv_to_rgb.bias"] = (ch,)
    out["embeddings.embeddings.weight"] = (cfg["class_embed_dim"],
                                           cfg["num_classes"])
    return out


def class_embedding(W, label: int):
    """The embedding of class ``label``: ``[1, embed_dim]``."""
    return W["embeddings.embeddings.weight"][:, label][None].clone()


def _bn(W, prefix, x, truncation, cfg, cond=None):
    coef, start_f = math.modf(float(truncation) / 0.02)
    start = min(int(start_f), cfg["n_stats"] - 1)
    means, vars_ = W[f"{prefix}.running_means"], W[f"{prefix}.running_vars"]
    if coef != 0.0:
        nxt = min(start + 1, cfg["n_stats"] - 1)
        mean = means[start] * coef + means[nxt] * (1.0 - coef)
        var = vars_[start] * coef + vars_[nxt] * (1.0 - coef)
    else:
        mean, var = means[start], vars_[start]
    x_hat = (x - mean[None, :, None, None]) * torch.rsqrt(
        var + cfg["bn_eps"])[None, :, None, None]
    if cond is None:
        return (x_hat * W[f"{prefix}.weight"][None, :, None, None]
                + W[f"{prefix}.bias"][None, :, None, None])
    gain = 1.0 + cond @ W[f"{prefix}.scale.weight"].t()
    bias = cond @ W[f"{prefix}.offset.weight"].t()
    return x_hat * gain[:, :, None, None] + bias[:, :, None, None]


def attention(theta, phi, g):
    """``softmax(theta phi^T) g`` over ``[n, q, d]``, ``[n, k, d]``,
    ``[n, k, dv]``, no scale."""
    return torch.softmax(theta @ phi.transpose(1, 2), dim=-1) @ g


def self_attn(W, prefix, x):
    n, c, h, w = x.shape

    def rows(t):
        return t.permute(0, 2, 3, 1).reshape(n, -1, t.shape[1])

    theta = rows(F.conv2d(x, W[f"{prefix}.theta.weight"]))
    phi = rows(F.max_pool2d(F.conv2d(x, W[f"{prefix}.phi.weight"]), 2, 2))
    g = rows(F.max_pool2d(F.conv2d(x, W[f"{prefix}.g.weight"]), 2, 2))
    o = attention(theta, phi, g).reshape(n, h, w, c // 2).permute(0, 3, 1, 2)
    return x + W[f"{prefix}.gamma"] * F.conv2d(o, W[f"{prefix}.o_conv.weight"])


def _block(W, prefix, x, truncation, cond, up, out_size, cfg):
    h = x
    for j in range(4):
        h = F.relu(_bn(W, f"{prefix}.bn_{j}", h, truncation, cfg, cond))
        if j == 1 and up:
            h = F.interpolate(h, scale_factor=2, mode="nearest")
        h = F.conv2d(h, W[f"{prefix}.conv_{j}.weight"],
                     W[f"{prefix}.conv_{j}.bias"], padding=1 if j in (1, 2)
                     else 0)
    skip = x[:, :out_size]
    if up:
        skip = F.interpolate(skip, scale_factor=2, mode="nearest")
    return skip + h


def generate(W, z, c, cfg, truncation=1.0):
    """Images ``[n, H, W, 3]`` in [-1, 1] of ``z`` and ``c`` (``[n, 128]``)."""
    ch = cfg["channel_width"]
    cond = torch.cat([z, c], dim=1)
    h = cond @ W["generator.gen_z.weight"].t() + W["generator.gen_z.bias"]
    h = h.view(-1, 4, 4, 16 * ch).permute(0, 3, 1, 2)
    for i, (up, _, out_mult) in enumerate(cfg["layers"]):
        if i == cfg["attention_position"]:
            h = self_attn(W, f"generator.attn_{i}", h)
        h = _block(W, f"generator.block_{i}", h, truncation, cond, up,
                   out_mult * ch, cfg)
    h = F.relu(_bn(W, "generator.bn_out", h, truncation, cfg))
    h = F.conv2d(h, W["generator.conv_to_rgb.weight"][:3],
                 W["generator.conv_to_rgb.bias"][:3], padding=1)
    return torch.tanh(h).permute(0, 2, 3, 1)
