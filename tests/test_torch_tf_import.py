"""The port's TF import (``sggan_tpu_torch/utils/{import_tf,tf_weights,
tf_bundle}.py``) on the CPU, against the JAX package's.

For each of the five nets, a bundle that the JAX package's TensorBundle
writer made from seeded weights is imported by the port into a
``cp-NNNN.pt`` checkpoint that holds exactly ``params_from_jax`` of the
tree that the JAX package's ``tf_weights.load_bundle_weights`` (or
``load_pix2pix_weights``) reads from it, and the service serves it.  The
``.npz`` route, the shape check, the cycle refusal and ``--selftest``
follow the JAX module.  The copy of ``tf_bundle`` is held by
``tests/test_torch_tf_bundle.py``."""

import json
import os
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sggan_tpu.utils import tf_bundle as jbundle  # noqa: E402
from sggan_tpu.utils import tf_weights as jweights  # noqa: E402
from sggan_tpu_torch import serve as tsrv  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from sggan_tpu_torch.utils import import_tf  # noqa: E402
from sggan_tpu_torch.utils.bridge import (_bn_to_jax,  # noqa: E402
                                          params_from_jax, params_to_jax)

NETS = {"resnet": dict(use_resnet=True), "unet": {},
        "pix2pix": dict(use_pix2pix=True)}


def _cfg(tmp_path, **kw):
    return Config(dataset_dir=str(tmp_path), image_height=32, image_width=32,
                  ngf=4, ndf=4, segment_class=4, compute_dtype="float32",
                  checkpoint_dir=str(tmp_path / "ckpt"), **kw)


def _random(tree, rng):
    if isinstance(tree, dict):
        return {k: _random(v, rng) for k, v in tree.items()}
    return rng.standard_normal(np.shape(tree)).astype(np.float32)


def _n_valid(tree):
    return len([k for k in tree if re.fullmatch(r"v\d+", k)])


def _write_tf(cfg, tmp_path, rng):
    """Seeded TF-layout weights of both nets ``cfg`` selects, written as
    ``Model.save_weights`` bundles by the JAX package's writer.  Returns
    {"gen"|"disc": (prefix, params tree, BN tree or None, layout kw)}."""
    nets = tstep.init_state(cfg, torch.Generator().manual_seed(1), "cpu")
    out = {}
    for which, net, bn in (("gen", nets.gen_params, nets.gen_bn),
                           ("disc", nets.disc_params, nets.disc_bn)):
        params = _random(params_to_jax(net.state_dict()), rng)
        prefix = str(tmp_path / "tf" / which / "cp-0007.ckpt")
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        if cfg.use_pix2pix:
            bn = _random(_bn_to_jax(bn), rng)
            kw = dict(image_size=cfg.image_height) if which == "gen" else {}
            flat, attrs = jweights.extract_pix2pix_weights(which, params, bn,
                                                           **kw)
        else:
            bn, kind = None, ("discriminator" if which == "disc" else
                              "resnet" if cfg.use_resnet else "unet")
            kw = ({"n_valid": _n_valid(params)} if which == "disc" else {})
            flat, attrs = jweights.extract_flat_weights(kind, params, **kw)
            kw["kind"] = kind
        jbundle.write_keras_weights(prefix, flat, attrs, compress=True,
                                    block_size=256)
        out[which] = (prefix, params, bn, kw)
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _jax_import(prefix, params, bn, kw):
    """The JAX package's reading of a bundle into zero trees of the same
    shapes: (params, BN state or None) as numpy trees."""
    zero = _tree_map(np.zeros_like, params)
    if bn is not None:
        which = "gen" if "image_size" in kw else "disc"
        p, s = jweights.load_pix2pix_weights(
            prefix, which, zero, _tree_map(np.zeros_like, bn), **kw)
        return _tree_map(np.asarray, p), _tree_map(np.asarray, s)
    kw = dict(kw)
    p = jweights.load_bundle_weights(prefix, kw.pop("kind"), zero, **kw)
    return _tree_map(np.asarray, p), None


def _read_port_checkpoint(cfg, epoch):
    tmpl = tstep.init_state(cfg, torch.Generator().manual_seed(9), "cpu")
    state = tckpt.load(tmpl, cfg.checkpoint_dir, cfg.dataset_dir, epoch)
    assert state is not None
    return state


def _assert_state_dict_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("net", NETS)
def test_import_matches_the_jax_import(net, tmp_path, capsys):
    """The CLI on both nets' bundles: the checkpoint holds exactly the JAX
    import's weights (and moving stats), the EMA shadow restarts from the
    generator, and the service serves it."""
    cfg = _cfg(tmp_path, gen_ema=0.999, **NETS[net])
    src = _write_tf(cfg, tmp_path, np.random.default_rng(0))
    flags = ["--img_height", "32", "--img_width", "32", "--ngf", "4",
             "--ndf", "4", "--segment_class", "4", "--compute_dtype",
             "float32", "--dataset_dir", str(tmp_path), "--checkpoint_dir",
             str(tmp_path / "ckpt"), "--gen_ema", "0.999",
             *{"resnet": ["--use_resnet"], "unet": [],
               "pix2pix": ["--use_pix2pix"]}[net]]
    import_tf.main(["--gen_src", src["gen"][0], "--disc_src",
                    src["disc"][0], "--epoch_tag", "7", *flags],
                   device="cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"ok": True, "checkpoint_dir": cfg.checkpoint_dir,
                    "dataset": cfg.dataset_dir, "epoch": 7, "net": net,
                    "disc": True}
    assert tckpt.latest_epoch(cfg.checkpoint_dir, cfg.dataset_dir) == 7
    state = _read_port_checkpoint(cfg, 7)
    for which, module, bn in (("gen", state.gen_params, state.gen_bn),
                              ("disc", state.disc_params, state.disc_bn)):
        params, want_bn = _jax_import(*src[which])
        _assert_state_dict_equal(module.state_dict(),
                                 params_from_jax(params))
        if want_bn is not None:
            got_bn = _bn_to_jax(bn)
            assert got_bn.keys() == want_bn.keys()
            for k, stats in want_bn.items():
                for n, a in stats.items():
                    np.testing.assert_array_equal(got_bn[k][n], a)
    _assert_state_dict_equal(state.ema, state.gen_params.state_dict())
    svc = tsrv._Service(cfg, device="cpu")
    assert svc.loaded is True
    x = np.random.default_rng(2).random((1, 32, 32, 3), np.float32)
    np.testing.assert_array_equal(svc._fn(x), evaluate.generate(
        cfg, state.gen_params, x, torch.device("cpu"), gen_bn=state.gen_bn))


def test_npz_route_matches_the_bundle_route(tmp_path):
    cfg = _cfg(tmp_path, use_resnet=True)
    prefix, params, _, _ = _write_tf(cfg, tmp_path,
                                     np.random.default_rng(4))["gen"]
    flat = jbundle.keras_weights(prefix)
    npz = str(tmp_path / "gen.npz")
    np.savez(npz, **{f"w{i}": w for i, w in enumerate(flat)})
    got = import_tf.import_checkpoint(cfg, npz, epoch_tag=1, device="cpu")
    _assert_state_dict_equal(got.gen_params.state_dict(),
                             params_from_jax(params))


def test_shape_mismatch_names_the_leaf(tmp_path):
    cfg = _cfg(tmp_path, use_resnet=True)
    prefix = _write_tf(cfg, tmp_path, np.random.default_rng(5))["gen"][0]
    with pytest.raises(ValueError, match=r"c1/w: shape \(7, 7, 3, 4\) != "
                                         r"expected \(7, 7, 3, 8\)"):
        import_tf.import_checkpoint(cfg.replace(ngf=8), prefix,
                                    device="cpu")
    assert tckpt.latest_epoch(cfg.checkpoint_dir, cfg.dataset_dir) is None


def test_cycle_is_refused_as_the_jax_import_refuses_it(tmp_path):
    from sggan_tpu.config import Config as JConfig
    from sggan_tpu.utils import import_tf as jimport

    with pytest.raises(NotImplementedError) as want:
        jimport.import_checkpoint(JConfig(loss_mode="cycle"), "x.npz")
    with pytest.raises(NotImplementedError) as got:
        import_tf.import_checkpoint(_cfg(tmp_path, loss_mode="cycle"),
                                    "x.npz", device="cpu")
    assert str(got.value) == str(want.value)


def test_selftest_prints_the_jax_line(monkeypatch, capsys):
    """``--selftest`` round-trips all five nets; run here at narrow widths
    (the counts of weights do not depend on them; the CLI's full widths
    cost minutes of pure-Python checksums)."""
    from functools import partial

    from sggan_tpu_torch.models import (discriminator, discriminator_pix2pix,
                                        generator_pix2pix, generator_resnet,
                                        generator_unet)

    for mod, cls, kw in (
            (generator_resnet, "GeneratorResnet", {"ngf": 4}),
            (generator_unet, "GeneratorUnet", {"ngf": 4}),
            (discriminator, "Discriminator", {"ndf": 4, "n_class": 4}),
            (generator_pix2pix, "GeneratorPix2pix", {"ngf": 4}),
            (discriminator_pix2pix, "DiscriminatorPix2pix", {"ndf": 4})):
        monkeypatch.setattr(mod, cls, partial(getattr(mod, cls), **kw))
    import_tf.main(["--selftest"])
    line = json.loads(capsys.readouterr().out)
    assert line == {"ok": True, "selftest": {
        "resnet": len(jweights.resnet_layout()),
        "unet": len(jweights.unet_layout()),
        "discriminator": len(jweights.discriminator_layout(3)),
        "pix2pix_gen": len(jweights.pix2pix_gen_layout()),
        "pix2pix_disc": len(jweights.pix2pix_disc_layout())}}
