"""BigGAN-deep generator in PyTorch (counterpart of
``pix2latent_tpu/models/biggan.py``).

The same architecture (Brock et al., arXiv:1809.11096, BigGAN-deep as in
HuggingFace's ``pytorch_pretrained_biggan``): the 128-d class embedding
concatenated with z conditions every BatchNorm; bottleneck residual blocks
with nearest-neighbour upsampling and channel-truncation skips, whose
convolutions run the block convolution kernel on the card in float32
(``ops/block_conv.py``); one SA-GAN self-attention block at 64x64, which
runs the hand-written attention kernel on the card (``ops/attention.py``);
BatchNorm over standing statistics interpolated by truncation.

Inputs ``z`` and ``c`` are ``[pop, 128]``; the output is NHWC float32 in
[-1, 1]. Inside, activations are NCHW. Parameters are float32; with
``dtype=torch.bfloat16`` every layer casts its weights and computes in bf16,
as the Flax modules' ``dtype`` does. Parameter names follow the Flax tree, so
``utils/params_io.py`` carries weights across, and the random init draws the
same numbers as the JAX package's for the same seed.
"""

from __future__ import annotations

import math
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pix2latent_tpu_torch.models.base import checkpointed
from pix2latent_tpu_torch.ops.attention import sagan_attention
from pix2latent_tpu_torch.ops.block_conv import block_conv2d
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.params_io import (_flatten, from_jax_params,
                                                  jax_to_torch_array,
                                                  load_params_npz,
                                                  sorted_jax_leaves)

# (up_sample, in_mult, out_mult) per block; attention before block
# `attention_position`. Mirrors the pytorch_pretrained_biggan configs.
BIGGAN_CONFIGS = {
    "biggan-deep-128": dict(
        output_dim=128,
        layers=[(False, 16, 16), (True, 16, 16), (False, 16, 16),
                (True, 16, 8), (False, 8, 8), (True, 8, 4),
                (False, 4, 4), (True, 4, 2), (False, 2, 2), (True, 2, 1)],
        attention_position=8),
    "biggan-deep-256": dict(
        output_dim=256,
        layers=[(False, 16, 16), (True, 16, 16), (False, 16, 16),
                (True, 16, 8), (False, 8, 8), (True, 8, 8),
                (False, 8, 8), (True, 8, 4), (False, 4, 4),
                (True, 4, 2), (False, 2, 2), (True, 2, 1)],
        attention_position=8),
    "biggan-deep-512": dict(
        output_dim=512,
        layers=[(False, 16, 16), (True, 16, 16), (False, 16, 16),
                (True, 16, 8), (False, 8, 8), (True, 8, 8),
                (False, 8, 8), (True, 8, 4), (False, 4, 4),
                (True, 4, 2), (False, 2, 2), (True, 2, 1),
                (False, 1, 1), (True, 1, 1)],
        attention_position=8),
}

Z_DIM = 128
EMBED_DIM = 128
CHANNEL_WIDTH = 128
N_STATS = 51
BN_EPS = 1e-4


def _conv(x, layer, padding=0):
    """``layer``'s conv in x's dtype (weights cast at use)."""
    b = layer.bias.to(x.dtype) if layer.bias is not None else None
    return F.conv2d(x, layer.weight.to(x.dtype), b, padding=padding)


def _channels(v):
    return v[None, :, None, None]


class StandingBatchNorm(nn.Module):
    """BatchNorm over standing statistics interpolated by truncation, with
    HF ``BigGANBatchNorm``'s quirks: ``math.modf(truncation / 0.02)`` in
    float64 (truncation 1.0 gives start 49 and coef ~1) and the REVERSED
    lerp ``stats[start] * coef + stats[start + 1] * (1 - coef)``. Affine
    parameters come from linear heads on the condition vector when
    ``conditional``, else per-channel weight and bias."""

    def __init__(self, num_features, conditional=True,
                 cond_dim=Z_DIM + EMBED_DIM):
        super().__init__()
        self.conditional = conditional
        self.running_means = nn.Parameter(torch.zeros(N_STATS, num_features))
        self.running_vars = nn.Parameter(torch.ones(N_STATS, num_features))
        if conditional:
            self.scale = nn.Linear(cond_dim, num_features, bias=False)
            self.offset = nn.Linear(cond_dim, num_features, bias=False)
        else:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x, truncation, cond=None):
        if not isinstance(truncation, (int, float)):
            raise TypeError("truncation must be a Python number (the "
                            "standing-stats interpolation uses float64 modf); "
                            f"got {type(truncation)}")
        coef, start_f = math.modf(float(truncation) / 0.02)
        start = min(int(start_f), N_STATS - 1)
        means, vars_ = self.running_means, self.running_vars
        if coef != 0.0:
            nxt = min(start + 1, N_STATS - 1)
            mean = means[start] * coef + means[nxt] * (1.0 - coef)
            var = vars_[start] * coef + vars_[nxt] * (1.0 - coef)
        else:
            mean, var = means[start], vars_[start]
        inv = torch.rsqrt(var + BN_EPS)
        x_hat = (x - _channels(mean.to(x.dtype))) * _channels(inv.to(x.dtype))
        if self.conditional:
            gain = 1.0 + F.linear(cond, self.scale.weight.to(cond.dtype))
            bias = F.linear(cond, self.offset.weight.to(cond.dtype))
            return x_hat * gain[:, :, None, None] + bias[:, :, None, None]
        return (x_hat * _channels(self.weight.to(x.dtype))
                + _channels(self.bias.to(x.dtype)))


class SelfAttn(nn.Module):
    """SA-GAN non-local block: theta/phi/g 1x1 convs, 2x2 max-pooled keys
    and values, scalar gamma residual. Attention inputs are flattened
    H-then-W with channels last, as the Flax block does."""

    def __init__(self, in_channels):
        super().__init__()
        c = in_channels
        self.theta = nn.Conv2d(c, c // 8, 1, bias=False)
        self.phi = nn.Conv2d(c, c // 8, 1, bias=False)
        self.g = nn.Conv2d(c, c // 2, 1, bias=False)
        self.o_conv = nn.Conv2d(c // 2, c, 1, bias=False)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        n, c, h, w = x.shape

        def rows(t):                       # NCHW -> [n, H*W, C] contiguous
            return t.permute(0, 2, 3, 1).reshape(n, -1, t.shape[1]).contiguous()

        theta = rows(_conv(x, self.theta))
        phi = rows(F.max_pool2d(_conv(x, self.phi), 2, 2))
        g = rows(F.max_pool2d(_conv(x, self.g), 2, 2))
        o = sagan_attention(theta, phi, g)
        o = o.reshape(n, h, w, c // 2).permute(0, 3, 1, 2)
        o = _conv(o, self.o_conv)
        return x + self.gamma.to(x.dtype) * o


def _upsample2x(x):
    """Nearest-neighbour 2x upsample (NCHW)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class SlicedOutputConv(nn.Module):
    """3x3 SAME conv that keeps the full ``[features, in, 3, 3]`` kernel of
    HF's conv_to_rgb but computes only the first ``used`` output channels
    (the only ones the model consumes)."""

    def __init__(self, in_ch, features, used=3):
        super().__init__()
        self.used = used
        self.weight = nn.Parameter(torch.zeros(features, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv2d(x, self.weight[:self.used].to(x.dtype),
                        self.bias[:self.used].to(x.dtype), padding=1)


class GenBlock(nn.Module):
    """BigGAN-deep bottleneck residual block: four cond-BN + ReLU + conv
    stages at channels/4, optional 2x upsample before the middle 3x3s, skip
    by channel truncation + upsample. The four convolutions go through
    ``block_conv2d``: the hand-written kernel for float32 on the card,
    ``F.conv2d`` otherwise."""

    def __init__(self, in_size, out_size, up_sample=False, reduction_factor=4):
        super().__init__()
        mid = in_size // reduction_factor
        self.out_size = out_size
        self.up_sample = up_sample
        self.bn_0 = StandingBatchNorm(in_size)
        self.conv_0 = nn.Conv2d(in_size, mid, 1)
        self.bn_1 = StandingBatchNorm(mid)
        self.conv_1 = nn.Conv2d(mid, mid, 3, padding=1)
        self.bn_2 = StandingBatchNorm(mid)
        self.conv_2 = nn.Conv2d(mid, mid, 3, padding=1)
        self.bn_3 = StandingBatchNorm(mid)
        self.conv_3 = nn.Conv2d(mid, out_size, 1)

    def forward(self, x, truncation, cond):
        h = F.relu(self.bn_0(x, truncation, cond))
        h = block_conv2d(h, self.conv_0.weight, self.conv_0.bias)
        h = F.relu(self.bn_1(h, truncation, cond))
        if self.up_sample:
            h = _upsample2x(h)
        h = block_conv2d(h, self.conv_1.weight, self.conv_1.bias, padding=1)
        h = F.relu(self.bn_2(h, truncation, cond))
        h = block_conv2d(h, self.conv_2.weight, self.conv_2.bias, padding=1)
        h = F.relu(self.bn_3(h, truncation, cond))
        h = block_conv2d(h, self.conv_3.weight, self.conv_3.bias)
        skip = x[:, :self.out_size]
        if self.up_sample:
            skip = _upsample2x(skip)
        return skip + h


def genblock_conv_shapes(generator, rows):
    """Every ``GenBlock`` convolution of ``generator`` (a
    ``BigGANDeepGenerator``, on any device, ``meta`` too) at ``rows``
    images, read from its blocks' weights: ``(block, layer, input shape [n,
    cin, h, w], weight shape [cout, cin, k, k])`` in the order the forward
    runs them."""
    out, res = [], 4
    for i in range(len(generator.layers)):
        block = getattr(generator, f"block_{i}")
        for name in ("conv_0", "conv_1", "conv_2", "conv_3"):
            if name == "conv_1" and block.up_sample:
                res *= 2
            w = tuple(getattr(block, name).weight.shape)
            out.append((i, name, (rows, w[1], res, res), w))
    return out


class BigGANDeepGenerator(nn.Module):
    """cond = concat(z, class embedding) feeds gen_z and every conditional
    BN; blocks per BIGGAN_CONFIGS; 3-channel tanh output (NHWC, f32)."""

    def __init__(self, model_version="biggan-deep-256",
                 channel_width=CHANNEL_WIDTH, dtype=torch.float32,
                 remat=False, remat_from_res=0):
        super().__init__()
        cfg = BIGGAN_CONFIGS[model_version]
        ch = channel_width
        self.dtype = dtype
        self.remat = bool(remat)
        self.remat_from_res = int(remat_from_res)
        self.ch = ch
        self.layers = cfg["layers"]
        self.attn_pos = cfg["attention_position"]
        self.gen_z = nn.Linear(Z_DIM + EMBED_DIM, 4 * 4 * 16 * ch)
        for i, (up, in_mult, out_mult) in enumerate(self.layers):
            if i == self.attn_pos:
                setattr(self, f"attn_{i}", SelfAttn(in_mult * ch))
            setattr(self, f"block_{i}",
                    GenBlock(in_mult * ch, out_mult * ch, up_sample=up))
        self.bn_out = StandingBatchNorm(self.layers[-1][2] * ch,
                                        conditional=False)
        self.conv_to_rgb = SlicedOutputConv(ch, ch, used=3)

    def forward(self, z, c, truncation=1.0):
        cond = torch.cat([z, c], dim=1).to(self.dtype)
        h = F.linear(cond, self.gen_z.weight.to(self.dtype),
                     self.gen_z.bias.to(self.dtype))
        # HF views gen_z's output as [N, 4, 4, 16ch] (H, W, C order)
        h = h.view(-1, 4, 4, 16 * self.ch).permute(0, 3, 1, 2)
        res = 4
        for i, (up, _, _) in enumerate(self.layers):
            if i == self.attn_pos:
                h = getattr(self, f"attn_{i}")(h)
            if up:
                res *= 2
            block = getattr(self, f"block_{i}")
            if torch.is_grad_enabled() and (self.remat or (
                    self.remat_from_res and res >= self.remat_from_res)):
                # the JAX package's nn.remat: the backward recomputes the
                # block's activations
                h = checkpointed(block, h, truncation, cond, res=res)
            else:
                h = block(h, truncation, cond)
        h = F.relu(self.bn_out(h, truncation))
        h = self.conv_to_rgb(h)
        return torch.tanh(h).float().permute(0, 2, 3, 1)


class ClassEmbeddings(nn.Module):
    """one-hot(1000) -> 128-d class embedding."""

    def __init__(self, num_classes=1000, embed_dim=EMBED_DIM):
        super().__init__()
        self.embeddings = nn.Linear(num_classes, embed_dim, bias=False)

    def forward(self, onehot):
        return self.embeddings(onehot)


def _random_init_(module: nn.Module, seed: int):
    """Fill ``module`` with ``N(0, 0.02^2)`` values drawn from
    ``np.random.RandomState(seed)`` in the JAX package's leaf order and
    shapes (``models/biggan.py:_random_leaves``), so the same seed gives the
    same weights; standing statistics become mean 0, variance 1."""
    rng = np.random.RandomState(seed)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for path, shape, name in sorted_jax_leaves(module):
            arr = np.asarray(rng.randn(*shape), np.float32) * 0.02
            if path.endswith("running_means"):
                arr = np.zeros_like(arr)
            elif path.endswith("running_vars"):
                arr = np.ones_like(arr)
            params[name].copy_(torch.as_tensor(jax_to_torch_array(path, arr)))


class BigGAN(nn.Module):
    """User-facing BigGAN: ``forward(z, c, truncation)`` and
    ``get_class_embedding(int | one-hot)``.

    ``params``: the JAX package's parameter tree ``{"generator": ...,
    "embeddings": ...}``, nested or flat (``/``-joined paths);
    ``pretrained_path``: a ``.npz`` written by ``save_params_npz`` (either
    package's) or a ``pytorch_pretrained_biggan`` state dict saved by
    ``torch.save`` (``.pt`` / ``.pth``), converted by
    :func:`convert_torch_biggan`. With neither, a deterministic random init from ``seed``. ``remat`` recomputes
    every residual block's activations in the backward instead of keeping
    them, ``remat_from_res`` the blocks whose output resolution is at least
    that (``torch.utils.checkpoint``, the JAX package's ``nn.remat``).
    """

    def __init__(self, model_version: str = "biggan-deep-256", params=None,
                 pretrained_path: Optional[str] = None,
                 dtype=torch.float32, seed: int = 0,
                 channel_width: int = CHANNEL_WIDTH, remat: bool = False,
                 remat_from_res: int = 0, device="cuda"):
        super().__init__()
        if model_version not in BIGGAN_CONFIGS:
            raise ValueError(f"unknown BigGAN version {model_version!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        self.model_version = model_version
        self.generator = BigGANDeepGenerator(model_version, channel_width,
                                             dtype, remat=remat,
                                             remat_from_res=remat_from_res)
        self.embeddings = ClassEmbeddings()
        if params is None and pretrained_path:
            params = load_pretrained(pretrained_path, model_version)
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                params = _flatten(params)
            self.load_state_dict(from_jax_params(params), strict=True)
        else:
            warnings.warn("BigGAN: no pretrained weights — deterministic "
                          "random init", stacklevel=2)
            _random_init_(self.generator, seed)
            _random_init_(self.embeddings, seed + 1)
        self.requires_grad_(False)
        self.to(device)
        self.device = device
        self.im_res = BIGGAN_CONFIGS[model_version]["output_dim"]

    def get_class_embedding(self, cls):
        """int class index or one-hot [n, 1000] -> embedding [n, 128]."""
        if isinstance(cls, (int, np.integer)):
            onehot = torch.zeros((1, 1000), device=self.device)
            onehot[:, int(cls)] = 1.0
        else:
            onehot = torch.as_tensor(cls, dtype=torch.float32,
                                     device=self.device)
            if onehot.dim() != 2:
                raise ValueError("expected one-hot [n, 1000]")
        return self.embeddings(onehot)

    def forward(self, z, c, truncation=1.0):
        if not 0 < truncation <= 1:
            raise ValueError(f"truncation must be in (0, 1], got {truncation}")
        if z.dim() != 2:
            raise ValueError("expected z to be 2D")
        if c.dim() != 2 or c.shape[1] != EMBED_DIM:
            raise ValueError(f"expected c of shape (?, {EMBED_DIM}) but got "
                             f"{tuple(c.shape)}")
        return self.generator(z, c, truncation)


# --------------------------------------------------------------------- #
# weight conversion (pytorch_pretrained_biggan state dict)               #
# --------------------------------------------------------------------- #

def _np(value):
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


def _sn_effective_weight(sd, prefix):
    """The weight of ``prefix`` with its spectral norm baked in: ``W_orig /
    (u^T W v)`` by one power step from the stored ``weight_u``, as torch's
    ``spectral_norm`` computes it at eval. A plain ``weight`` is returned
    as it is."""
    w_key = f"{prefix}.weight_orig"
    if w_key not in sd:
        return _np(sd[f"{prefix}.weight"])
    w = _np(sd[w_key])
    u = _np(sd[f"{prefix}.weight_u"])
    w_mat = w.reshape(w.shape[0], -1)
    v = w_mat.T @ u
    v = v / max(np.linalg.norm(v), 1e-12)
    u2 = w_mat @ v
    sigma = float(u2 @ u)
    return w / max(sigma, 1e-12)


def convert_torch_biggan(state_dict, model_version="biggan-deep-256"):
    """A ``pytorch_pretrained_biggan`` state dict as the JAX package's nested
    parameter tree of numpy arrays (``{"generator": ..., "embeddings":
    ...}``), which :class:`BigGAN` loads through ``from_jax_params``.

    Convs OIHW -> HWIO, linears ``[out, in]`` -> ``[in, out]``, spectral norm
    baked with the stored ``weight_u`` (:func:`_sn_effective_weight`). The
    checkpoint keeps its blocks and the attention layer in one list,
    ``generator.layers.<i>``, where attention takes a slot of its own."""
    sd = dict(state_dict)
    cfg = BIGGAN_CONFIGS[model_version]

    def lin(prefix):
        p = {"kernel": _sn_effective_weight(sd, prefix).T}
        if f"{prefix}.bias" in sd:
            p["bias"] = _np(sd[f"{prefix}.bias"])
        return p

    def conv(prefix):
        w = _sn_effective_weight(sd, prefix)
        p = {"kernel": np.transpose(w, (2, 3, 1, 0))}
        if f"{prefix}.bias" in sd:
            p["bias"] = _np(sd[f"{prefix}.bias"])
        return p

    def bn(prefix, conditional=True):
        p = {"running_means": _np(sd[f"{prefix}.running_means"]),
             "running_vars": _np(sd[f"{prefix}.running_vars"])}
        if conditional:
            p["scale"] = lin(f"{prefix}.scale")
            p["offset"] = lin(f"{prefix}.offset")
        else:
            p["weight"] = _np(sd[f"{prefix}.weight"])
            p["bias"] = _np(sd[f"{prefix}.bias"])
        return p

    gen = {"gen_z": lin("generator.gen_z")}
    t_idx = 0
    for i in range(len(cfg["layers"])):
        if i == cfg["attention_position"]:
            ap = f"generator.layers.{t_idx}"
            gen[f"attn_{i}"] = {
                "theta": conv(f"{ap}.snconv1x1_theta"),
                "phi": conv(f"{ap}.snconv1x1_phi"),
                "g": conv(f"{ap}.snconv1x1_g"),
                "o_conv": conv(f"{ap}.snconv1x1_o_conv"),
                "gamma": _np(sd[f"{ap}.gamma"]).reshape(()),
            }
            t_idx += 1
        bp = f"generator.layers.{t_idx}"
        gen[f"block_{i}"] = {f"{kind}_{j}": (bn if kind == "bn" else conv)(
            f"{bp}.{kind}_{j}") for j in range(4) for kind in ("bn", "conv")}
        t_idx += 1
    gen["bn_out"] = bn("generator.bn", conditional=False)
    gen["conv_to_rgb"] = conv("generator.conv_to_rgb")
    # the class embedding: a plain Linear(1000 -> 128), no bias, no SN
    emb = {"embeddings": {"kernel": _np(sd["embeddings.weight"]).T}}
    return {"generator": gen, "embeddings": emb}


def load_pretrained(path, model_version="biggan-deep-256"):
    """The parameter tree in ``path``: a ``.npz`` of ``save_params_npz``
    (flat), or a ``.pt`` / ``.pth`` state dict of ``pytorch_pretrained_biggan``
    (converted). Any other file raises ``ValueError``."""
    path = str(path)
    if path.endswith(".npz"):
        if not zipfile.is_zipfile(path):
            raise ValueError(f"{path!r} is not a .npz archive of "
                             "save_params_npz")
        return load_params_npz(path)
    if path.endswith((".pt", ".pth")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return convert_torch_biggan(sd, model_version)
    raise ValueError(f"BigGAN weights {path!r}: expected a .npz written by "
                     "save_params_npz or a pytorch_pretrained_biggan state "
                     "dict saved as .pt / .pth")
