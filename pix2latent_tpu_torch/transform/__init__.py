"""Spatial and color transform search (counterpart of
``pix2latent_tpu/transform/``): the differentiable affine alignment
(``SpatialTransform``), the color transforms, their weighted composition and
the transform-search BasinCMA driver. Transforms act on NHWC images and keep
their defaults on an explicit device."""

from pix2latent_tpu_torch.transform.base import TransformTemplate
from pix2latent_tpu_torch.transform.spatial import SpatialTransform
from pix2latent_tpu_torch.transform.color import (BrightnessTransform,
                                                  ColorTransform,
                                                  ContrastTransform,
                                                  GammaTransform,
                                                  HueTransform,
                                                  SaturationTransform)
from pix2latent_tpu_torch.transform.compose import (ComposeTransform,
                                                    SpatialOnly)
from pix2latent_tpu_torch.transform.transform_optimizer import (
    TransformBasinCMAOptimizer)
from pix2latent_tpu_torch.transform.utils import setup_transform_fn

__all__ = ["TransformTemplate", "SpatialTransform", "ComposeTransform",
           "SpatialOnly",
           "ColorTransform", "HueTransform", "BrightnessTransform",
           "GammaTransform", "SaturationTransform", "ContrastTransform",
           "TransformBasinCMAOptimizer", "setup_transform_fn"]
