from .layers import (conv2d, conv2d_init, conv2d_reflect, conv2d_transpose,
                     conv2d_transpose_init, dropout, dropout_masks,
                     glorot_uniform, leaky_relu, normal_init, reflect_pad,
                     relu, tanh, unpad_reflect_transpose)
from .norm import (batch_norm, batch_norm_init, instance_norm,
                   instance_norm_bwd_ref, instance_norm_init,
                   instance_norm_ref)

__all__ = [
    "conv2d", "conv2d_init", "conv2d_reflect", "conv2d_transpose",
    "conv2d_transpose_init", "dropout", "dropout_masks", "glorot_uniform",
    "leaky_relu", "normal_init", "reflect_pad", "relu", "tanh",
    "batch_norm", "batch_norm_init", "instance_norm", "instance_norm_bwd_ref",
    "instance_norm_init", "instance_norm_ref", "unpad_reflect_transpose",
]
