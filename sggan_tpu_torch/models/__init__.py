"""Model zoo of the port: so far the ResNet generator."""

from . import generator_resnet

__all__ = ["generator_resnet"]
