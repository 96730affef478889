"""sggan_tpu_torch — the PyTorch and CUDA port of ``sggan_tpu`` for an
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``sggan_tpu`` is the reference: every module here mirrors
the module of the same path there, and the tests hold each against it on
the same weights and inputs.  This package imports ``torch`` and never
``jax``.

Ported: everything of the JAX CLI that runs on one device: every net and
loss mode's train step (``--compat_fake_history`` too), the trainer
behind ``python -m sggan_tpu_torch.main`` (``--eval_crf`` too), with
``--scan_steps`` chunks replaying one CUDA graph of the step, the service
with its deployment path (``torch.export`` artifacts, the reference-TF2
import), the memory probe, the FLOP model, the data tools and
``cycle_recon_eval``; data parallelism (``--mesh_data``) and spatial
sharding (``--mesh_space``, ``--mesh_space_w``) of every step that the
JAX package shards, one rank per card over ``torch.distributed``, the
split resident on each rank, the step and its NCCL collectives one CUDA
graph; and the reading of the JAX package's Orbax checkpoints, so that
the port resumes, tests and serves a JAX run.

    config    — the reference CLI and ``Config``: the port's own copy,
                held to the JAX one by a test
    ops       — TF-semantics conv / conv-transpose / reflect pad, Keras
                leaky_relu, the loss filters (``deriv``), the
                space-to-depth head (``s2d``), instance norm and batch
                norm (``norm``: instance norm as an autograd Function, a
                registered op ``torch.ops.sggan_tpu_torch.instance_norm``
                and the spatial path's split passes) with its hand-written
                CUDA kernels, forward and backward (``cuda_in``,
                ``csrc/instance_norm.cu``), the fused conv3x3 + instance
                norm (``cuda_conv_in``, ``csrc/conv3_in.cu``; no net calls
                it) and the nvcc and g++ builds (``_build``)
    models    — ``generator_resnet``, ``generator_unet``,
                ``discriminator`` and the pix2pix pair
                (``generator_pix2pix``, ``discriminator_pix2pix``) as
                ``nn.Module``s whose parameter names follow the JAX trees
    losses    — every criterion and loss of the reference
    data      — ``loader`` (host decode, the split resident on the
                card), ``augment`` and ``preprocess`` (on the device, with
                explicit draws); the offline tools ``segment_class`` and
                ``prepare_data``
    metrics   — ``scores``: confusion-matrix scores; ``crf``: the dense
                CRF, native, on the host
    train     — ``pool`` (the (fake, mask) image pool with explicit
                draws, the fake history's plan), ``step`` (the train step
                with Adam and the EMA), ``cycle`` (the cycle mode's step),
                ``fused`` (batch assembly, the epoch over the resident
                split, ``StepGraph``: the step as one CUDA graph),
                ``evaluate`` (generate, eval, test, samples) and
                ``trainer``
    utils     — ``bridge`` (JAX parameter trees and train states <-> the
                port's), ``checkpoint`` (the port's files and the JAX
                package's Orbax directories), ``orbax``, ``ocdbt`` and
                ``zstd`` (the Orbax reader: its items, its key-value
                store, the host zstd decoder), ``cuda_graph`` (capture,
                the forward graphs), ``images``, ``summary`` (tfevents),
                ``profiling``, ``export`` (``torch.export`` artifacts),
                ``tf_bundle``, ``tf_weights`` and ``import_tf`` (the
                reference-TF2 import), ``flops`` (the analytic FLOP
                model), ``hbm`` (the memory probe)
    parallel  — ``distributed`` (the process group from torchrun's
                environment, the ``data`` DeviceMesh), ``mesh`` (the
                (data, space, wspace) layout and its groups, the
                reference's refusals), ``dp`` (the step's mean over
                ranks, the pool's rows per rank, per-shard draws, rank 0's
                state broadcast), ``spatial`` (the halo exchange, the
                sharded ops and nets, the gathers) and ``spatial_step``
                (the sharded steps)
    main      — the CLI: ``python -m sggan_tpu_torch.main``
    serve     — the HTTP translate service, on a checkpoint or an
                artifact (``--export``, ``--artifact``)
    cycle_recon_eval — a cycle run's reconstruction and identity scores
    perf_in, perf_conv_in — what K1's launch plan and K2's table rest on,
                measured on the card

Layout: public functions take and return NHWC tensors, like the JAX
package; in memory that is PyTorch's ``channels_last``, so the convs see
NCHW views without a copy.
"""

__version__ = "0.1.0"
