"""sggan_tpu_torch — the PyTorch and CUDA port of ``sggan_tpu`` for an
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``sggan_tpu`` is the reference: every module here mirrors
the module of the same path there, and the tests hold each against it on
the same weights and inputs.  This package imports ``torch`` and never
``jax``.

Ported so far: the serving path of the ResNet generator.

    config    — the reference CLI and ``Config``, shared with sggan_tpu
                (framework-free; imported, not copied)
    ops       — TF-semantics conv / conv-transpose / reflect pad, instance
                norm with its hand-written CUDA kernel (``cuda_in``,
                ``csrc/instance_norm.cu``) and the nvcc build (``_build``)
    models    — ``generator_resnet`` as an ``nn.Module`` whose parameter
                names follow the JAX parameter tree
    train     — ``evaluate``: the inference half (input convention,
                compute dtype, sharpening)
    utils     — ``bridge``: JAX parameter trees <-> ``state_dict``
    serve     — the HTTP translate service

Layout: public functions take and return NHWC tensors, like the JAX
package; in memory that is PyTorch's ``channels_last``, so the convs see
NCHW views without a copy.
"""

__version__ = "0.1.0"
