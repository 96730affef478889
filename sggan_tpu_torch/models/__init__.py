"""Model zoo of the port, with the JAX package's selection
(``sggan_tpu/models/__init__.py``, reference model.py:54-62):

    use_resnet   -> ResNet generator + semantic discriminator
    use_pix2pix  -> pix2pix generator + pix2pix discriminator
    default      -> U-Net generator + semantic discriminator
"""

from . import (discriminator, discriminator_pix2pix, generator_pix2pix,
               generator_resnet, generator_unet)


def build(cfg):
    """(generator class, discriminator class) per the reference's flag
    logic."""
    if cfg.use_resnet:
        return generator_resnet.GeneratorResnet, discriminator.Discriminator
    if cfg.use_pix2pix:
        return (generator_pix2pix.GeneratorPix2pix,
                discriminator_pix2pix.DiscriminatorPix2pix)
    return generator_unet.GeneratorUnet, discriminator.Discriminator


__all__ = ["build", "discriminator", "discriminator_pix2pix",
           "generator_pix2pix", "generator_resnet", "generator_unet"]
