"""The mesh of a multi-card job, port of ``sggan_tpu/parallel/mesh.py``.

The JAX package builds a ``jax.sharding.Mesh`` with a ``data`` axis (the
batch sharded, gradients averaged), a ``space`` axis (the image's rows
sharded, with halo exchange) and an optional ``wspace`` axis.  The port
runs data parallelism only, as one rank per card (``parallel/dp.py``):
its mesh is a 1-D ``torch.distributed.DeviceMesh`` named ``data`` over
the default process group (``distributed.global_mesh``).  Spatial
sharding is ROADMAP Queue 1, item 10 ("parallel: spatial"): asking for
it raises.
"""

from __future__ import annotations

DATA_AXIS = "data"

SPATIAL_TODO = ("parallel: spatial sharding (--mesh_space > 1, the halo "
                "exchange of parallel/spatial.py) is not ported yet "
                "(ROADMAP Queue 1, item 10); the port runs data "
                "parallelism only")


def check_space(space: int = 1, wspace: int = 1) -> None:
    if space > 1 or wspace > 1:
        raise NotImplementedError(SPATIAL_TODO)
