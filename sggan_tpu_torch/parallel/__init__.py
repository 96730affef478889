"""Data parallelism over ``torch.distributed``, one rank per card: port of
``sggan_tpu/parallel`` without its spatial sharding (ROADMAP Queue 1,
item 10)."""

from .mesh import DATA_AXIS

__all__ = ["DATA_AXIS"]
