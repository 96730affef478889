"""Data parallelism and spatial sharding over ``torch.distributed``, one
rank per card: port of ``sggan_tpu/parallel``, every step of it (the
semantic nets' and the pix2pix nets' spatial steps among them)."""

from .mesh import DATA_AXIS

__all__ = ["DATA_AXIS"]
