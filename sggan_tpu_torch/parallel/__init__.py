"""Data parallelism and spatial sharding over ``torch.distributed``, one
rank per card: port of ``sggan_tpu/parallel`` (its pix2pix spatial step
and multi-host spatial sharding excepted, ROADMAP Queue 1, item 10)."""

from .mesh import DATA_AXIS

__all__ = ["DATA_AXIS"]
