"""Abstract transform interface (counterpart of
``pix2latent_tpu/transform/base.py``)."""


class TransformTemplate:
    """A searchable image transform.

    ``__call__(ims, t, invert=False)`` returns a new tensor and leaves its
    inputs as they are, so a transform can sit inside a step and be
    differentiated where the transform is differentiable.
    """

    def __call__(self, ims, t, invert=False):
        """Apply (or invert) the transformation parametrized by ``t``."""
        raise NotImplementedError

    def get_default_param(self):
        """Default (starting) transformation parameter."""
        raise NotImplementedError

    def get_identity_param(self):
        """Parameter at which the transform is the identity."""
        raise NotImplementedError

    def transform(self, ims, t):
        raise NotImplementedError

    def invert_transform(self, ims, t):
        raise NotImplementedError
