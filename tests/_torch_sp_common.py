"""Helpers of the port's spatial tests (not collected), imported by the
test files and by the ranks of ``tests/_torch_sp_worker.py``: the ops held
against the JAX package's ``sggan_tpu/parallel/spatial.py`` and the
assembly of the ranks' blocks into global arrays.  Imports torch and the
port only, never JAX."""

import numpy as np

from sggan_tpu_torch.parallel.mesh import rank_of

# name -> (whether it needs the wspace axis, whether it has a vjp)
OPS = {
    "halo_h": (False, True), "halo_w": (True, True),
    "conv_s1": (False, True), "conv_s2": (False, True),
    "conv_reflect7": (False, True),
    "convT_s1": (False, True), "convT_s2": (False, True),
    "reflect1": (False, True), "reflect3": (False, True),
    "in_none": (False, True), "in_relu": (False, True),
    "in_leaky": (False, True),
    "seg_weight": (False, False), "gradloss": (False, True),
}
ACTS = {"in_none": None, "in_relu": "relu", "in_leaky": "leaky_relu"}


def run_op(name, x, params, blk, grid):
    """The port's op ``name`` on this rank's block ``x`` (``blk`` holds
    the other inputs' blocks, ``params`` the op's tensors in torch
    layout).  ``gradloss`` returns this block's local mean."""
    import torch

    from sggan_tpu_torch.parallel import spatial as sp
    f32 = torch.float32
    if name == "halo_h":
        return sp.halo_exchange(x, 1, 2, grid.h, 1)
    if name == "halo_w":
        return sp.halo_exchange(x, 2, 1, grid.wax, 2)
    if name.startswith("conv_s"):
        return sp.conv2d_sp(params, x, int(name[-1]), grid, f32)
    if name == "conv_reflect7":
        return sp.conv2d_valid_after_reflect_sp(
            params, sp.reflect_pad_sp(x, 3, grid), f32)
    if name.startswith("convT_s"):
        return sp.conv2d_transpose_sp(params, x, int(name[-1]), grid, f32)
    if name.startswith("reflect"):
        return sp.reflect_pad_sp(x, int(name[-1]), grid)
    if name in ACTS:
        return sp.instance_norm_sp(params, x, grid, ACTS[name])
    if name == "seg_weight":
        return sp.seg_boundary_weight_sp(blk["seg"], grid)
    if name == "gradloss":
        return sp.gradloss_criterion_sp(x, blk["tgt"], blk["wt"], grid)
    raise KeyError(name)


def assemble(blocks, sizes):
    """The global array of the ranks' ``blocks`` (rank order) over a (D,
    S, W) layout: data rows along dim 0, space along 1, wspace along 2."""
    D, S, W = sizes
    rows = []
    for d in range(D):
        cols = [np.concatenate([blocks[rank_of(d, s, w, S, W)]
                                for w in range(W)], axis=2)
                for s in range(S)]
        rows.append(np.concatenate(cols, axis=1))
    return np.concatenate(rows, axis=0)


def rel_err(got, ref) -> float:
    """max |got - ref| over max |ref| (0 where both are 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(initial=0.0)
    d = np.abs(got - ref).max(initial=0.0)
    return d / scale if scale else d
