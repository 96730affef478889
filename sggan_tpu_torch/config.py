"""The reference CLI and typed ``Config``, shared with the JAX package.

``sggan_tpu.config`` imports only ``argparse``, ``dataclasses`` and
``typing`` (and ``sggan_tpu/__init__.py`` is a docstring), so importing it
pulls in no JAX.  One definition keeps the two packages' flags identical.
"""

from sggan_tpu.config import Config, build_parser, config_from_namespace

__all__ = ["Config", "build_parser", "config_from_namespace"]
