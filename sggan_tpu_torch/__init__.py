"""sggan_tpu_torch — the PyTorch and CUDA port of ``sggan_tpu`` for an
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``sggan_tpu`` is the reference: every module here mirrors
the module of the same path there, and the tests hold each against it on
the same weights and inputs.  This package imports ``torch`` and never
``jax``.

Ported so far: everything of the JAX CLI that runs on one device: every
net and loss mode's train step (``--compat_fake_history`` too), the
trainer behind ``python -m sggan_tpu_torch.main`` (``--eval_crf`` too),
the service with its deployment path (``torch.export`` artifacts, the
reference-TF2 import), the memory probe, the FLOP model, the data tools
and ``cycle_recon_eval``.  Not yet: the meshes (``parallel``).

    config    — the reference CLI and ``Config``: the port's own copy,
                held to the JAX one by a test
    ops       — TF-semantics conv / conv-transpose / reflect pad, Keras
                leaky_relu, the loss filters (``deriv``), instance norm as
                an autograd Function and a registered op (``torch.ops.
                sggan_tpu_torch.instance_norm``) with its hand-written CUDA
                kernels,
                forward and backward (``cuda_in``, ``csrc/instance_norm.cu``)
                and the nvcc and g++ builds (``_build``)
    models    — ``generator_resnet`` and ``discriminator`` as
                ``nn.Module``s whose parameter names follow the JAX trees
    losses    — every criterion and loss of the reference
    data      — ``loader`` (host decode, the split resident on the
                card), ``augment`` and ``preprocess`` (on the device, with
                explicit draws); the offline tools ``segment_class`` and
                ``prepare_data``
    metrics   — ``scores``: confusion-matrix scores; ``crf``: the dense
                CRF, native, on the host
    train     — ``pool`` (the (fake, mask) image pool with explicit
                draws, the fake history's plan), ``step`` (the train step with Adam and the EMA),
                ``fused`` (batch assembly and the epoch over the resident
                split), ``evaluate`` (generate, eval, test, samples) and
                ``trainer``
    utils     — ``bridge`` (JAX parameter trees and train states <-> the
                port's), ``checkpoint``, ``images``, ``summary``
                (tfevents), ``profiling``, ``export`` (``torch.export``
                artifacts), ``tf_bundle``, ``tf_weights`` and ``import_tf``
                (the reference-TF2 import), ``flops`` (the analytic FLOP
                model), ``hbm`` (the memory probe)
    main      — the CLI: ``python -m sggan_tpu_torch.main``
    serve     — the HTTP translate service, on a checkpoint or an
                artifact (``--export``, ``--artifact``)
    cycle_recon_eval — a cycle run's reconstruction and identity scores

Layout: public functions take and return NHWC tensors, like the JAX
package; in memory that is PyTorch's ``channels_last``, so the convs see
NCHW views without a copy.
"""

__version__ = "0.1.0"
