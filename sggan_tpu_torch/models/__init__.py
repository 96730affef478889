"""Model zoo of the port: the ResNet generator and the semantic
discriminator."""

from . import discriminator, generator_resnet

__all__ = ["discriminator", "generator_resnet"]
