"""StyleGAN2 generator in PyTorch (counterpart of
``pix2latent_tpu/models/stylegan2.py``).

The same architecture (Karras et al., arXiv:1912.04958, config-f, as in
rosinality's stylegan2-pytorch): an 8-layer mapping network (equalized
linear, lr_mul 0.01, pixel-norm input); skip-architecture synthesis with
modulated 3x3 convs and weight demodulation, FIR-blurred transposed-conv
upsampling, per-layer noise, and 1x1 ToRGB taps accumulated through
FIR-upsampled skips; equalized-lr scales applied at run time.

The modulated conv scales the input, ``conv(x * s)``, and multiplies the
output by the demodulation factor of ``(W, s)``, as the JAX package does:
one shared conv per layer, no per-sample weights. That conv routes by what
the call can observe (``ops/block_conv.modulated_conv2d``): in float32 on
the card, its 3x3 convs and its up-convs (the stride-2 transposed conv, by
four output phases) run the hand-written 3xTF32 implicit GEMM of
``csrc/block_conv.cu``, forward and input gradient, on the weight packed
once with its run-time scale; on the CPU, in bfloat16, on packed pairs (2
groups) and for the 1x1 ToRGB, ``F.conv2d`` and ``F.conv_transpose2d`` run
as they are. At config-f's shapes (22 rows) the kernel takes [22, 512, 4,
4] to [22, 32, 1024, 1024], K = 288 to 4608: bound by operations up to 256
px, by both at cars' 512 px 3x3 and by bytes at FFHQ's 1024 px 3x3 (5.9 GB
against 424 GFLOP). Two opt-in flags, both off by default as in the JAX
package, put the other hand-written kernels on the path:

- ``fused_mod_bwd``: the modulation's backward runs ``ops/mod_backward.py``
  (K3) on every modulated conv;
- ``fir_kernel``: the blur after every upsampling conv runs
  ``ops/fir_blur.py`` (K2). The JAX generator has this blur on its XLA path
  only; the function is the same.

Inputs: ``z [pop, 512]`` (and, for ``search="w+"``, a flattened noise vector
``[pop, noise_dim]``); the output is NHWC float32 in [-1, 1]. Inside,
activations are NCHW. Parameters are float32; with ``dtype=torch.bfloat16``
every layer casts its weights and input and computes in bf16, as the Flax
modules' ``dtype`` does, and the same values stay float32 where the JAX
package's type promotion keeps them so: the demodulation factors, the noise
injection's output (its gain is a float32 parameter) and everything after it
up to the next conv, and the RGB skip sum. ``remat_from_res`` recomputes
the synthesis blocks at and above that resolution in the backward (see
``StyleGAN2Generator._block_runner``). ``pack_pairs_max_ch`` (off by
default, as in the JAX package) runs the blocks of at most that many
channels on population pairs packed into the channel dimension
(:func:`pack_pairs`), each shared conv as a 2-group conv; the function is
the same. Parameter names follow the Flax
tree, so ``utils/params_io.py`` (layout ``STYLEGAN2``) carries weights
across, and the random init draws the same numbers as the JAX package's for
the same seed.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from pix2latent_tpu_torch.models.base import checkpointed
from pix2latent_tpu_torch.ops.block_conv import modulated_conv2d
from pix2latent_tpu_torch.ops.mod_backward import modulate
from pix2latent_tpu_torch.ops.upfirdn2d import Blur, Upsample, fused_leaky_relu
from pix2latent_tpu_torch.utils.device import resolve_device
from pix2latent_tpu_torch.utils.params_io import (STYLEGAN2, _flatten,
                                                  from_jax_params,
                                                  load_params_npz,
                                                  sorted_jax_leaves)

BLUR_KERNEL = (1, 3, 3, 1)
STYLE_DIM = 512


def channels_for(res: int, channel_multiplier: int = 2) -> int:
    """rosinality channel map (model.py Generator.channels)."""
    return {
        4: 512, 8: 512, 16: 512, 32: 512,
        64: 256 * channel_multiplier,
        128: 128 * channel_multiplier,
        256: 64 * channel_multiplier,
        512: 32 * channel_multiplier,
        1024: 16 * channel_multiplier,
    }[res]


def pack_pairs(x):
    """``[n, c, H, W] -> [n/2, 2c, H, W]``: member i in channels ``[:c]``,
    member ``i + n/2`` in ``[c:]``, a channel concat of the two batch
    halves. The JAX package packs so to fill the TPU's 128 lanes at thin
    channels; the frozen shared-weight convs stay exact as 2-group convs
    (there a dense block-diagonal kernel). Any fixed pairing is valid:
    members are independent."""
    n = x.shape[0]
    return torch.cat([x[:n // 2], x[n // 2:]], dim=1)


def unpack_pairs(y):
    """Inverse of :func:`pack_pairs` (the original member order)."""
    c = y.shape[1] // 2
    return torch.cat([y[:, :c], y[:, c:]], dim=0)


def pack_rows(s):
    """Per-sample rows ``[n, c] -> [n/2, 2c]`` paired as :func:`pack_pairs`
    pairs members: styles and demodulation factors of packed channels."""
    n = s.shape[0]
    return torch.cat([s[:n // 2], s[n // 2:]], dim=-1)


def modulated_conv_inputs(im_res: int, n: int, channel_multiplier: int = 2):
    """``(name, (n, ch, r, r))`` of each modulated conv's input in the
    generator at ``im_res`` on ``n`` samples, in the forward's order. The
    modulation scales a conv's input, so these are the shapes the fused
    modulation backward (K3) takes: conv1 and to_rgb1 at 4 px, then at each
    r = 8 .. im_res the up-conv (on the r/2 input), the conv and to_rgb."""
    cm = channel_multiplier
    shapes = [("conv1", (n, channels_for(4, cm), 4, 4)),
              ("to_rgb1", (n, channels_for(4, cm), 4, 4))]
    for i in range(3, int(math.log2(im_res)) + 1):
        r = 2 ** i
        shapes += [(f"up_conv{r}", (n, channels_for(r // 2, cm), r // 2, r // 2)),
                   (f"conv{r}", (n, channels_for(r, cm), r, r)),
                   (f"to_rgb{r}", (n, channels_for(r, cm), r, r))]
    return shapes


def modulated_conv_shapes(generator, rows):
    """Every 3x3 modulated conv of ``generator`` (a ``StyleGAN2Generator``,
    on any device, ``meta`` too) at ``rows`` samples, read from its
    layers' weights: ``(name, up, input shape [n, cin, h, w], weight shape
    [cout, cin, 3, 3])`` in the forward's order; an ``up`` conv's output is
    2h+1 x 2w+1 before its blur. These are the convs the block convolution
    kernel takes in float32 (the ToRGBs' 1x1s are left out)."""
    out = [("conv1", False, 4)]
    for li in range(generator.log_size - 2):
        res = 2 ** (li + 3)
        out += [(f"convs_{2 * li}", True, res // 2),
                (f"convs_{2 * li + 1}", False, res)]
    shapes = []
    for name, up, res in out:
        w = tuple(getattr(generator, name).conv.weight.shape)
        shapes.append((name, up, (rows, w[1], res, res), w))
    return shapes


def pixel_norm(x, eps=1e-8):
    return x * torch.rsqrt((x ** 2).mean(dim=-1, keepdim=True) + eps)


class EqualLinear(nn.Module):
    """Equalized-lr linear: runtime scale ``lr_mul / sqrt(in_dim)``; the
    weight is stored ``[out, in]``."""

    def __init__(self, in_dim, out_dim, lr_mul=1.0, bias_init=0.0,
                 activation=False, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(out_dim, in_dim))
        self.bias = nn.Parameter(torch.full((out_dim,), float(bias_init)))
        self.scale = (1.0 / math.sqrt(in_dim)) * lr_mul
        self.lr_mul = lr_mul
        self.activation = activation
        self.dtype = dtype

    def forward(self, x):
        out = F.linear(x.to(self.dtype), (self.weight * self.scale).to(self.dtype))
        bias = (self.bias * self.lr_mul).to(self.dtype)
        if self.activation:
            return fused_leaky_relu(out, bias)
        return out + bias


class ModulatedConv(nn.Module):
    """Weight-(de)modulated conv by input scaling. The weight is stored
    ``[out, in, k, k]`` with runtime scale ``1/sqrt(in*k*k)``. ``up=True``
    runs the stride-2 transposed conv of the weight (output 2H+1) and the
    FIR blur with pad (1, 1) and gain 4, which brings it to 2H. The conv
    itself is ``ops/block_conv.modulated_conv2d`` (the kernel in float32 on
    the card).

    ``packed``: the layer may run on packed pairs (:func:`pack_pairs`); it
    does when ``forward`` is told so. It excludes ``fused_mod_bwd``, as in
    the JAX package."""

    def __init__(self, in_ch, out_ch, kernel_size=3, demodulate=True,
                 up=False, dtype=torch.float32, fused_mod_bwd=False,
                 fir_kernel=False, packed=False):
        super().__init__()
        if packed and fused_mod_bwd:
            raise ValueError("fused_mod_bwd and pack_pairs are mutually "
                             "exclusive opt-ins")
        k = kernel_size
        self.weight = nn.Parameter(torch.zeros(out_ch, in_ch, k, k))
        self.modulation = EqualLinear(STYLE_DIM, in_ch, bias_init=1.0,
                                      dtype=dtype)
        self.scale = 1.0 / math.sqrt(in_ch * k * k)
        self.kernel_size = k
        self.demodulate = demodulate
        self.up = up
        self.dtype = dtype
        self.fused_mod_bwd = fused_mod_bwd
        if up:
            p = len(BLUR_KERNEL) - 2 - (k - 1)
            self.blur = Blur(BLUR_KERNEL, pad=((p + 1) // 2 + 1, p // 2 + 1),
                             upsample_factor=2, use_kernel=fir_kernel)

    def forward(self, x, style, packed=False):
        """``x`` ``[n, in, H, W]``, or with ``packed`` ``[n/2, 2 in, H,
        W]`` (then the output is packed too)."""
        s = self.modulation(style)                           # [n, in]
        w = (self.weight * self.scale).to(self.dtype)        # [o, i, k, k]
        groups = 2 if packed else 1
        x_mod = modulate(x.to(self.dtype), pack_rows(s) if packed else s,
                         fused=self.fused_mod_bwd)
        y = modulated_conv2d(x_mod, self.weight, self.scale, w, up=self.up,
                             groups=groups)
        if self.up:
            y = self.blur(y)
        if self.demodulate:
            w2 = (w.float() ** 2).sum(dim=(2, 3)).t()        # [i, o]
            d = torch.rsqrt(s.float() ** 2 @ w2 + 1e-8)      # [n, o]
            if packed:
                d = pack_rows(d)
            y = y * d[:, :, None, None].to(y.dtype)
        return y


class NoiseInjection(nn.Module):
    """``x + weight * noise`` with a scalar float32 gain. As in the JAX
    package the gain promotes the sum to float32."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(()))

    def forward(self, x, noise, packed=False):
        if packed and noise.shape[0] > 1:
            # member i's noise to channels [:c], member i + n/2's to [c:]
            n2, c2, h, w = x.shape
            noise_p = torch.stack([noise[:n2, 0], noise[n2:, 0]], dim=1)
            y = (x.reshape(n2, 2, c2 // 2, h, w).float() + self.weight
                 * noise_p[:, :, None].to(x.dtype).float())
            return y.reshape(n2, c2, h, w)
        return x.float() + self.weight * noise.to(x.dtype).float()


def _runs_packed(module, x, style):
    """Whether a packable layer gets packed pairs: fewer rows than styles
    (the generator packs no single-sample batch)."""
    return module.packed and x.shape[0] != style.shape[0]


class StyledConv(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size=3, up=False,
                 dtype=torch.float32, fused_mod_bwd=False, fir_kernel=False,
                 packed=False):
        super().__init__()
        self.conv = ModulatedConv(in_ch, out_ch, kernel_size, up=up,
                                  dtype=dtype, fused_mod_bwd=fused_mod_bwd,
                                  fir_kernel=fir_kernel, packed=packed)
        self.noise = NoiseInjection()
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.packed = packed

    def forward(self, x, style, noise):
        packed = _runs_packed(self, x, style)
        y = self.noise(self.conv(x, style, packed), noise, packed)
        return fused_leaky_relu(y, self.bias.repeat(2) if packed
                                else self.bias)


class ToRGB(nn.Module):
    """1x1 modulated conv to RGB without demodulation, plus the upsampled
    skip; the RGB sum accumulates in float32."""

    def __init__(self, in_ch, upsample=True, dtype=torch.float32,
                 fused_mod_bwd=False, packed=False):
        super().__init__()
        self.conv = ModulatedConv(in_ch, 3, 1, demodulate=False, dtype=dtype,
                                  fused_mod_bwd=fused_mod_bwd, packed=packed)
        self.bias = nn.Parameter(torch.zeros(3))
        self.upsample = Upsample(BLUR_KERNEL) if upsample else None
        self.packed = packed

    def forward(self, x, style, skip=None):
        packed = _runs_packed(self, x, style)
        y = self.conv(x, style, packed)
        if packed:          # the RGB sum runs unpacked
            y = unpack_pairs(y)
        y = y.float() + self.bias[None, :, None, None]
        if skip is not None:
            if self.upsample is not None:
                skip = self.upsample(skip)
            y = y + skip
        return y


class StyleGAN2Generator(nn.Module):
    """Mapping + synthesis; ``forward`` mirrors rosinality's Generator for
    the two paths the reference uses: z (through the mapping network) and w
    with explicit noise. Returns the NCHW float32 RGB sum, unclamped.

    ``pack_pairs_max_ch``: the blocks of at most that many channels run on
    packed pairs, packed at the entry of the first such block (before its
    up-conv) and unpacked by each ToRGB; it needs an even population and
    excludes ``fused_mod_bwd``. 0 (the default) packs nothing."""

    def __init__(self, im_res=512, n_mlp=8, channel_multiplier=2,
                 dtype=torch.float32, fused_mod_bwd=False, fir_kernel=False,
                 remat_from_res=0, pack_pairs_max_ch=0):
        super().__init__()
        self.im_res = im_res
        self.remat_from_res = int(remat_from_res)
        self.log_size = int(math.log2(im_res))
        self.num_layers = (self.log_size - 2) * 2 + 1
        self.n_mlp = n_mlp
        cm = channel_multiplier
        for i in range(n_mlp):
            setattr(self, f"style_{i}", EqualLinear(
                STYLE_DIM, STYLE_DIM, lr_mul=0.01, activation=True,
                dtype=dtype))
        for i, res in enumerate(self.noise_resolutions()):
            setattr(self, f"noise_{i}", nn.Parameter(torch.zeros(1, 1, res, res)))
        ch = channels_for(4, cm)
        self.input = nn.Parameter(torch.zeros(1, ch, 4, 4))
        flags = dict(dtype=dtype, fused_mod_bwd=fused_mod_bwd)
        self.conv1 = StyledConv(ch, ch, fir_kernel=fir_kernel, **flags)
        self.to_rgb1 = ToRGB(ch, upsample=False, **flags)
        for li in range(self.log_size - 2):
            out = channels_for(2 ** (li + 3), cm)
            pk = bool(pack_pairs_max_ch) and out <= pack_pairs_max_ch
            setattr(self, f"convs_{2 * li}", StyledConv(
                ch, out, up=True, fir_kernel=fir_kernel, packed=pk, **flags))
            setattr(self, f"convs_{2 * li + 1}", StyledConv(
                out, out, fir_kernel=fir_kernel, packed=pk, **flags))
            setattr(self, f"to_rgbs_{li}", ToRGB(out, packed=pk, **flags))
            ch = out

    def noise_resolutions(self):
        return [2 ** ((i + 5) // 2) for i in range(self.num_layers)]

    def noise_buffers(self):
        return [getattr(self, f"noise_{i}") for i in range(self.num_layers)]

    def style(self, z):
        """Mapping network only: z -> w."""
        h = pixel_norm(z)
        for i in range(self.n_mlp):
            h = getattr(self, f"style_{i}")(h)
        return h

    def forward(self, z, noises=None, input_is_latent=False):
        w = z if input_is_latent else self.style(z)
        if noises is None:
            noises = self.noise_buffers()
        n = z.shape[0]
        x = self.input.expand(n, -1, -1, -1)
        x = self.conv1(x, w, noises[0])
        skip = self.to_rgb1(x, w)
        packed = False
        for li in range(self.log_size - 2):
            run = self._block_runner(2 ** (li + 3))
            up_conv = getattr(self, f"convs_{2 * li}")
            if up_conv.packed and not packed and n > 1:
                if n % 2:
                    raise ValueError(
                        f"pack_pairs requires an even population, got {n}")
                x, packed = pack_pairs(x), True
            x = run(up_conv, x, w, noises[2 * li + 1])
            x = run(getattr(self, f"convs_{2 * li + 1}"), x, w,
                    noises[2 * li + 2])
            skip = run(getattr(self, f"to_rgbs_{li}"), x, w, skip)
        return skip

    def _block_runner(self, res):
        """How the blocks of resolution ``res`` run: under
        ``torch.utils.checkpoint`` (the JAX package's ``nn.remat``) when
        ``remat_from_res`` is set, ``res`` is at or above it and gradients
        are on, so the backward recomputes their activations instead of
        keeping them (each recomputation a ``recompute`` span with
        ``res``, :func:`models.base.checkpointed`); else directly."""
        if not (self.remat_from_res and res >= self.remat_from_res
                and torch.is_grad_enabled()):
            return lambda block, *args: block(*args)
        return lambda block, *args: checkpointed(block, *args, res=res)


def _equalized(path: str, arr: np.ndarray) -> np.ndarray:
    """A standard-normal draw scaled as the Flax modules' own initializers
    (and rosinality's) set the leaf: EqualLinear weights N(0, 1) / lr_mul,
    the other weights, the constant input and the noise buffers N(0, 1),
    biases at their constants (1 for the style heads, else 0), noise gains
    0."""
    parts = path.split("/")
    if parts[-1] == "bias":
        return np.full_like(arr, 1.0 if "modulation" in parts else 0.0)
    if arr.ndim == 0:
        return np.zeros_like(arr)
    if parts[0].startswith("style_"):
        return arr / 0.01
    return arr


def _random_init_(module: nn.Module, seed: int, scheme: str = "jax"):
    """A deterministic random init: ``np.random.RandomState(seed).randn``
    over the Flax leaves in JAX's sorted order and shapes (0-d leaves draw
    one number too).

    ``scheme="jax"`` is the JAX package's zero-egress init
    (``models/stylegan2.py:463-471``): every draw times 0.1, 0-d leaves 0;
    the same seed gives the same weights. Under it the mapping network's
    output does not depend on z to float32 precision (each of its 8 layers
    scales the z-dependent part by about 1e-3 against its bias), so a z
    search cannot move the loss. ``scheme="equalized"`` scales the same
    draws as the modules' own initializers do (:func:`_equalized`), which
    keeps every layer near unit variance and the image dependent on z."""
    if scheme not in ("jax", "equalized"):
        raise ValueError(f"unknown init scheme {scheme!r}")
    rng = np.random.RandomState(seed)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for path, shape, name in sorted_jax_leaves(module, STYLEGAN2):
            arr = np.asarray(rng.randn(*shape), np.float32)
            if scheme == "jax":
                arr = arr * (0.1 if len(shape) else 0.0)
            else:
                arr = _equalized(path, arr)
            params[name].copy_(torch.as_tensor(
                STYLEGAN2.to_torch_array(path, arr)))


class StyleGAN2(nn.Module):
    """User-facing StyleGAN2 with the reference's interface: ``search='z'``
    runs the whole net on ``z``; ``search='w+'`` takes a w latent plus a
    flattened noise vector (:meth:`reshape_noise`). Output clamped to
    [-1, 1], NHWC.

    ``params``: the JAX package's parameter tree (nested or flat);
    ``pretrained_path``: a ``.npz`` written by ``save_params_npz`` or a
    rosinality checkpoint (``g_ema``). With neither, a deterministic random
    init from ``seed``: by default the JAX package's, or with
    ``init="equalized"`` the same draws at the modules' own scales (see
    :func:`_random_init_`). ``pack_pairs_max_ch``: see
    :class:`StyleGAN2Generator`.
    """

    MODELS = {"cars": 512, "ffhq": 1024}

    def __init__(self, model: str = "cars", search: str = "z", params=None,
                 pretrained_path: Optional[str] = None, seed: int = 0,
                 channel_multiplier: int = 2, dtype=torch.float32,
                 fused_mod_bwd: bool = False, fir_kernel: bool = False,
                 remat_from_res: int = 0, init: str = "jax",
                 pack_pairs_max_ch: int = 0, device="cuda"):
        super().__init__()
        if model not in self.MODELS:
            raise ValueError(f"unknown StyleGAN2 model {model!r}")
        if search not in ("z", "w+"):
            raise ValueError(f"search must be 'z' or 'w+', got {search!r}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        device = resolve_device(device)
        self.im_res = self.MODELS[model]
        self.search = search
        self.generator = StyleGAN2Generator(
            self.im_res, channel_multiplier=channel_multiplier, dtype=dtype,
            fused_mod_bwd=fused_mod_bwd, fir_kernel=fir_kernel,
            remat_from_res=remat_from_res,
            pack_pairs_max_ch=pack_pairs_max_ch)

        if params is None and pretrained_path:
            if str(pretrained_path).endswith(".npz"):
                params = load_params_npz(pretrained_path)
            else:
                ckpt = torch.load(pretrained_path, map_location="cpu")
                params = convert_torch_stylegan2(ckpt.get("g_ema", ckpt),
                                                 self.im_res)
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                params = _flatten(params)
            self.generator.load_state_dict(
                from_jax_params(params, STYLEGAN2), strict=True)
        else:
            warnings.warn("StyleGAN2: no pretrained weights — deterministic "
                          "random init", stacklevel=2)
            _random_init_(self.generator, seed, init)
        self.requires_grad_(False)
        self.to(device)
        self.device = device
        self.noise_shape = [[1, r, r, 1]
                            for r in self.generator.noise_resolutions()]
        self._mean_latent_cache = None

    # -- latent statistics ------------------------------------------------ #

    def _sample_w(self, n_sample, generator):
        z = torch.randn((n_sample, STYLE_DIM), generator=generator,
                        device=self.device)
        with torch.no_grad():
            return self.generator.style(z).float()

    def mean_latent(self, n_sample=4096, generator=None):
        """Mean w over ``n_sample`` random z, ``[1, 512]`` float32, cached.
        Drawn from ``generator`` (torch's stream, not the JAX package's)."""
        if self._mean_latent_cache is None:
            w = self._sample_w(n_sample, generator)
            self._mean_latent_cache = w.mean(dim=0, keepdim=True)
        return self._mean_latent_cache

    def latent_stats(self, n_sample=4096, generator=None):
        """(mean w [512], overall std) over ``n_sample`` random z."""
        w = self._sample_w(n_sample, generator)
        mean = w.mean(dim=0)
        std = torch.sqrt(((w - mean) ** 2).sum() / n_sample)
        return mean, std

    # -- forward paths ---------------------------------------------------- #

    def forward(self, z=None, noises=None):
        if self.search == "w+":
            out = self.generator(z, noises=self.reshape_noise(noises),
                                 input_is_latent=True)
        else:
            out = self.generator(z)
        return out.clamp(-1.0, 1.0).permute(0, 2, 3, 1)

    def reshape_noise(self, z):
        """Flattened per-layer noise ``[n, noise_dim]`` -> list of
        ``[n, 1, H, W]`` maps (row-major H, W: the same order as the JAX
        package's NHWC maps)."""
        st, noises = 0, []
        for _, h, w, _ in self.noise_shape:
            en = st + h * w
            noises.append(z[:, st:en].reshape(-1, 1, h, w))
            st = en
        if z.shape[1] != st:
            raise ValueError(f"noise vector has {z.shape[1]} values, "
                             f"expected {st}")
        return noises

    def noise_dim(self):
        return sum(h * w for _, h, w, _ in self.noise_shape)


# --------------------------------------------------------------------- #
# weight conversion (rosinality g_ema state_dict)                        #
# --------------------------------------------------------------------- #

def convert_torch_stylegan2(sd, im_res=512):
    """A rosinality ``g_ema`` state_dict as the JAX package's flat parameter
    dict (``/`` paths, JAX layouts), which :class:`StyleGAN2` loads through
    ``params_io``. Linear ``[out, in]`` -> ``[in, out]``; modulated conv
    ``[1, out, in, k, k]`` -> HWIO; ``input`` and noise buffers NCHW -> NHWC."""

    def arr(key):
        v = sd[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, np.float32)

    params = {}

    def eq_linear(dst, prefix):
        params[f"{dst}/weight"] = arr(f"{prefix}.weight").T
        if f"{prefix}.bias" in sd:
            params[f"{dst}/bias"] = arr(f"{prefix}.bias")

    def mod_conv(dst, prefix):
        params[f"{dst}/weight"] = arr(f"{prefix}.weight")[0].transpose(2, 3, 1, 0)
        eq_linear(f"{dst}/modulation", f"{prefix}.modulation")

    for i in range(8):
        eq_linear(f"style_{i}", f"style.{i + 1}")
    params["input"] = arr("input.input").transpose(0, 2, 3, 1)

    def styled_conv(dst, src):
        mod_conv(f"{dst}/conv", f"{src}.conv")
        params[f"{dst}/noise/weight"] = arr(f"{src}.noise.weight").reshape(())
        params[f"{dst}/bias"] = arr(f"{src}.activate.bias")

    def to_rgb(dst, src):
        mod_conv(f"{dst}/conv", f"{src}.conv")
        params[f"{dst}/bias"] = arr(f"{src}.bias").reshape(-1)

    styled_conv("conv1", "conv1")
    to_rgb("to_rgb1", "to_rgb1")
    log_size = int(math.log2(im_res))
    for li in range(log_size - 2):
        styled_conv(f"convs_{2 * li}", f"convs.{2 * li}")
        styled_conv(f"convs_{2 * li + 1}", f"convs.{2 * li + 1}")
        to_rgb(f"to_rgbs_{li}", f"to_rgbs.{li}")
    for i in range((log_size - 2) * 2 + 1):
        params[f"noise_{i}"] = arr(f"noises.noise_{i}").transpose(0, 2, 3, 1)
    return params
