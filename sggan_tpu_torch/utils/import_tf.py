"""Import a reference TF2 checkpoint into the port's checkpoint layout,
port of ``sggan_tpu/utils/import_tf.py``: the migration path for users
bringing trained SG-GAN-TF2 models.

The reference saves ``Model.save_weights`` TensorBundle checkpoints under
``checkpoint/<dataset>/{gen,disc}/cp-NNNN.ckpt`` (model.py:450-467).
This tool reads those directly (``utils/tf_bundle.py``, no TensorFlow
needed), or a ``.npz`` of the flat ``keras_model.get_weights()`` list
(export recipe in ``utils/tf_weights.py``), maps the weights onto the
port's nets through their TF-layout trees (``utils/bridge.py``), and
writes a ``cp-NNNN.pt`` checkpoint (``utils/checkpoint.py``) that
``--phase test``, ``--continue_train`` and ``serve`` read as it is (Adam
state fresh, step 0).

    python -m sggan_tpu_torch.utils.import_tf \\
        --gen_src  /path/checkpoint/city/gen/cp-0021.ckpt  \\
        [--disc_src /path/checkpoint/city/disc/cp-0021.ckpt] \\
        [--epoch_tag 21] <main.py flags, e.g. --dataset_dir city>

All five nets are supported: the ResNet and U-Net generators and the
semantic discriminator, and the pix2pix generator and discriminator,
whose Keras BatchNorm layers interleave running stats in the flat order;
those go into the nets' batch-norm state.  The nets are built on
``device``: the CLI's is ``cuda``.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch


def import_checkpoint(cfg, gen_src: str, disc_src: str = None,
                      epoch_tag: int = 0, device="cuda"):
    """Build a fresh train state on ``device``, overwrite the generator
    (and optionally the discriminator) with the TF weights, save under
    cfg.checkpoint_dir/<dataset>/.  Returns the state."""
    from ..train.step import init_state
    from . import checkpoint as ckpt
    from . import tf_weights
    from .bridge import _bn_from_jax, _bn_to_jax, params_from_jax, \
        params_to_jax

    if cfg.loss_mode == "cycle":
        raise NotImplementedError(
            "the reference trains single-direction models only — there is "
            "no two-generator TF checkpoint to import; train cycle mode "
            "from scratch or import into a single-direction config")
    state = init_state(cfg, torch.Generator().manual_seed(cfg.data_seed),
                       device)

    def load(src, which, net, **kw):
        tree = params_to_jax(net.state_dict())
        if src.endswith(".npz"):
            tree = tf_weights.load_npz_weights(src, which, tree, **kw)
        else:
            tree = tf_weights.load_bundle_weights(src, which, tree, **kw)
        net.load_state_dict(params_from_jax(tree))

    def load_p2p(src, which, net, bn, **kw):
        tree, bn = tf_weights.load_pix2pix_weights(
            src, which, params_to_jax(net.state_dict()), _bn_to_jax(bn),
            **kw)
        net.load_state_dict(params_from_jax(tree))
        return _bn_from_jax(bn, device)

    if cfg.use_pix2pix:
        state = state._replace(gen_bn=load_p2p(
            gen_src, "gen", state.gen_params, state.gen_bn,
            image_size=cfg.image_height))
        if disc_src:
            state = state._replace(disc_bn=load_p2p(
                disc_src, "disc", state.disc_params, state.disc_bn))
    else:
        load(gen_src, "resnet" if cfg.use_resnet else "unet",
             state.gen_params)
        if disc_src:
            n_valid = len([k for k, _ in state.disc_params.named_children()
                           if re.fullmatch(r"v\d+", k)])
            load(disc_src, "discriminator", state.disc_params,
                 n_valid=n_valid)
    if state.ema is not None:
        # the imported weights are the best estimate — restart the shadow
        state = state._replace(ema={
            k: p.detach().clone()
            for k, p in state.gen_params.named_parameters()})
    ckpt.save(state, cfg.checkpoint_dir, cfg.dataset_dir, epoch_tag)
    return state


def selftest(workdir: str = None) -> dict:
    """Round trip of the whole TF import path, as the JAX package's
    ``selftest``: for every net, randomize a real parameter tree, write it
    through the TensorBundle writer under Keras save_weights names
    (``tf_bundle.write_keras_weights``), then read it back through the
    import machinery (``keras_weights`` ordering, then the layouts'
    assignment) into a zero tree and require exact equality.  Covers raw
    and snappy tables, multi-block indexes (small block sizes), and the
    BN-stat interleave of the pix2pix nets.  The trees come from the
    port's nets (``params_to_jax`` of their ``state_dict``)."""
    import tempfile

    from ..models import (discriminator, discriminator_pix2pix,
                          generator_pix2pix, generator_resnet,
                          generator_unet)
    from . import tf_bundle, tf_weights
    from .bridge import _bn_to_jax, params_to_jax

    workdir = workdir or tempfile.mkdtemp(prefix="tfimport_selftest_")
    rng = np.random.default_rng(7)

    def randomize(tree):
        if isinstance(tree, dict):
            return {k: randomize(v) for k, v in tree.items()}
        return rng.normal(size=np.shape(tree)).astype(np.float32)

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return np.zeros(np.shape(tree), np.float32)

    def check(tree, got, where):
        if isinstance(tree, dict):
            for k in tree:
                check(tree[k], got[k], f"{where}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got), tree, where)

    results = {}
    cases = [
        ("resnet", generator_resnet.GeneratorResnet(), {}),
        ("unet", generator_unet.GeneratorUnet(), {}),
        ("discriminator",
         discriminator.Discriminator(image_size=(128, 128)), {"n_valid": 3}),
    ]
    for i, (net, module, kw) in enumerate(cases):
        params = randomize(params_to_jax(module.state_dict()))
        flat, attrs = tf_weights.extract_flat_weights(net, params, **kw)
        prefix = f"{workdir}/{net}/cp-0000.ckpt"
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        tf_bundle.write_keras_weights(prefix, flat, attrs,
                                      compress=bool(i % 2),
                                      block_size=512 if i else 4096)
        got = tf_weights.load_bundle_weights(prefix, net, zeros(params),
                                             **kw)
        check(params, got, net)
        results[net] = len(flat)

    for which, cls in (("gen", generator_pix2pix.GeneratorPix2pix),
                       ("disc", discriminator_pix2pix.DiscriminatorPix2pix)):
        module = cls()
        params = randomize(params_to_jax(module.state_dict()))
        bn = randomize(_bn_to_jax(module.init_bn_state()))
        flat, attrs = tf_weights.extract_pix2pix_weights(which, params, bn)
        prefix = f"{workdir}/p2p_{which}/cp-0000.ckpt"
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        tf_bundle.write_keras_weights(prefix, flat, attrs, compress=True,
                                      block_size=256)
        gp, gbn = tf_weights.load_pix2pix_weights(
            prefix, which, zeros(params), zeros(bn))
        check(params, gp, f"p2p_{which}/params")
        check(bn, gbn, f"p2p_{which}/bn")
        results[f"pix2pix_{which}"] = len(flat)
    return results


def main(argv=None, device="cuda"):
    from ..config import build_parser, config_from_namespace

    if argv is None:
        import sys
        argv = sys.argv[1:]
    if "--selftest" in argv:
        print(json.dumps({"ok": True, "selftest": selftest()}))
        return

    p = build_parser()
    p.add_argument("--gen_src", required=True,
                   help="generator TF checkpoint: TensorBundle prefix "
                        "(…/gen/cp-NNNN.ckpt) or get_weights() .npz")
    p.add_argument("--disc_src", default=None,
                   help="optional discriminator TF checkpoint")
    p.add_argument("--epoch_tag", type=int, default=0,
                   help="epoch number for the written cp-NNNN")
    ns = p.parse_args(argv)
    cfg = config_from_namespace(ns).validate()
    import_checkpoint(cfg, ns.gen_src, ns.disc_src, ns.epoch_tag, device)
    print(json.dumps({"ok": True, "checkpoint_dir": cfg.checkpoint_dir,
                      "dataset": cfg.dataset_dir,
                      "epoch": ns.epoch_tag,
                      "net": ("pix2pix" if cfg.use_pix2pix else
                              "resnet" if cfg.use_resnet else "unet"),
                      "disc": bool(ns.disc_src)}))


if __name__ == "__main__":
    main()
