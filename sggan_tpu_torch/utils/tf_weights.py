"""Map TF2/Keras weights onto parameter trees, the port's twin of
``sggan_tpu/utils/tf_weights.py``: the same five layouts and their
inverses, with numpy in place of ``jax.numpy``.  The trees are nested
dicts of numpy arrays in TF layout, as ``utils.bridge.params_to_jax``
gives them from a net's ``state_dict`` (and ``params_from_jax`` takes
them back): conv kernels HWIO, conv-transpose kernels (kh, kw, out, in),
which is what Keras stores.  ``utils/import_tf.py`` goes through the
bridge both ways.

The interchange format is a plain ``.npz`` holding the flat list from
``keras_model.get_weights()`` saved as ``w0, w1, ...`` (export one-liner,
run wherever TF is installed):

    np.savez("gen.npz", **{f"w{i}": w
                           for i, w in enumerate(model.get_weights())})

or the reference's own ``Model.save_weights`` TensorBundle
(``utils/tf_bundle.py``).  Keras returns weights in layer-creation order,
which matches the builder functions' construction order
(module.py:125-318); the maps below list (path, kind) per weight in that
order.  Shapes are checked leaf by leaf.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _conv(path: str, bias: bool = True) -> List[Tuple[str, str]]:
    w = [(path + "/w", "kernel")]
    return w + [(path + "/b", "bias")] if bias else w


def _in(path: str) -> List[Tuple[str, str]]:
    return [(path + "/gamma", "gamma"), (path + "/beta", "beta")]


def resnet_layout() -> List[Tuple[str, str]]:
    """generator_resnet weight order (module.py:219-269)."""
    out = _conv("c1") + _in("c1_in") + _conv("c2") + _in("c2_in") \
        + _conv("c3") + _in("c3_in")
    for i in range(1, 10):
        out += _conv(f"r{i}/conv1") + _in(f"r{i}/in1")
        out += _conv(f"r{i}/conv2") + _in(f"r{i}/in2")
    out += _conv("d1") + _in("d1_in") + _conv("d2") + _in("d2_in")
    out += _conv("out")
    return out


def unet_layout() -> List[Tuple[str, str]]:
    """generator_unet weight order (module.py:125-206)."""
    out: List[Tuple[str, str]] = []
    for i in range(1, 9):
        out += _conv(f"e{i}") + _in(f"e{i}_in")
    for i in range(1, 8):
        out += _conv(f"d{i}") + _in(f"d{i}_in")
    out += _conv("d8")
    return out


def discriminator_layout(n_valid: int = 3) -> List[Tuple[str, str]]:
    """Semantic discriminator weight order (module.py:272-318); n_valid is
    the VALID-chain length (3 at 128x128: h31/h32/h33)."""
    out = _conv("h0") + _conv("h1") + _in("h1_in") + _conv("h2") \
        + _in("h2_in") + _conv("h3") + _in("h3_in")
    for i in range(n_valid):
        out += _conv(f"v{i}") + _in(f"v{i}_in")
    out += _conv("h4")
    return out


_LAYOUTS = {
    "resnet": resnet_layout,
    "unet": unet_layout,
    "discriminator": discriminator_layout,
}


# ---- pix2pix nets: Keras BatchNorm interleaves running stats ----------
# Keras `Model.get_weights()` lists each layer's variables in creation
# order, trainables first WITHIN the layer: a BatchNormalization layer
# contributes [gamma, beta, moving_mean, moving_variance].  The pix2pix
# nets are the only reference models with BN (module.py:14-46), so their
# layouts route each weight into either the param tree ("p") or the
# functional BN-state tree ("s").

def _bn4(path: str) -> List[Tuple[str, str]]:
    return [("p", path + "/gamma"), ("p", path + "/beta"),
            ("s", path + "/moving_mean"), ("s", path + "/moving_var")]


def pix2pix_gen_layout(image_size: int = 128) -> List[Tuple[str, str]]:
    """generator_pix2pix weight order (module.py:48-95): n_down = log2(H)
    downsample convs (BN from the second), n_down-1 upsample convTs with
    BN, biased convT head (models/generator_pix2pix._plan)."""
    import math
    n_down = int(math.log2(image_size))
    out: List[Tuple[str, str]] = [("p", "down0/w")]
    for i in range(1, n_down):
        out += [("p", f"down{i}/w")] + _bn4(f"down{i}_bn")
    for i in range(n_down - 1):
        out += [("p", f"up{i}/w")] + _bn4(f"up{i}_bn")
    out += [("p", "last/w"), ("p", "last/b")]
    return out


def pix2pix_disc_layout() -> List[Tuple[str, str]]:
    """discriminator_pix2pix weight order (module.py:97-123)."""
    out: List[Tuple[str, str]] = [("p", "down0/w")]
    for i in (1, 2):
        out += [("p", f"down{i}/w")] + _bn4(f"down{i}_bn")
    out += [("p", "conv/w")] + _bn4("conv_bn")
    out += [("p", "last/w"), ("p", "last/b")]
    return out


def assign_flat_weights_bn(flat, layout, params, bn_state):
    """Like assign_flat_weights, but each layout entry ("p"|"s", path)
    routes into the param tree or the BN running-stats tree.  Returns
    (new_params, new_bn_state)."""
    if len(flat) != len(layout):
        raise ValueError(
            f"expected {len(layout)} weights, got {len(flat)}")
    new_p, new_s = _copy_tree(params), _copy_tree(bn_state)
    for w, (tree, path) in zip(flat, layout):
        node = new_p if tree == "p" else new_s
        parts = path.split("/")
        for q in parts[:-1]:
            node = node[q]
        leaf = parts[-1]
        if tuple(node[leaf].shape) != tuple(np.shape(w)):
            raise ValueError(
                f"{path}: shape {np.shape(w)} != expected "
                f"{node[leaf].shape}")
        node[leaf] = np.asarray(w, dtype=node[leaf].dtype)
    return new_p, new_s


def load_pix2pix_weights(src, which: str, params, bn_state,
                         image_size: int = 128):
    """which: "gen" | "disc"; src: npz path or TensorBundle prefix."""
    layout = pix2pix_gen_layout(image_size) if which == "gen" \
        else pix2pix_disc_layout()
    if str(src).endswith(".npz"):
        data = np.load(src)
        flat = [data[f"w{i}"] for i in range(len(data.files))]
    else:
        from .tf_bundle import keras_weights
        flat = keras_weights(src)
    return assign_flat_weights_bn(flat, layout, params, bn_state)


def load_npz_weights(path_or_file, net: str, params, **layout_kw):
    """Fill the param tree `params` (``params_to_jax`` of a net's
    ``state_dict``) with weights from
    the npz flat list.  Shapes are validated leaf by leaf."""
    data = np.load(path_or_file)
    flat = [data[f"w{i}"] for i in range(len(data.files))]
    return assign_flat_weights(flat, net, params, **layout_kw)


def load_bundle_weights(prefix: str, net: str, params, **layout_kw):
    """Load a reference ``Model.save_weights`` TensorBundle checkpoint
    (e.g. checkpoint/<ds>/gen/cp-0021.ckpt) directly — no TF, no npz
    export step (tf_bundle.py)."""
    from .tf_bundle import keras_weights
    return assign_flat_weights(keras_weights(prefix), net, params,
                               **layout_kw)


def assign_flat_weights(flat, net: str, params, **layout_kw):
    layout = [("p", path) for path, _ in _LAYOUTS[net](**layout_kw)]
    new, _ = assign_flat_weights_bn(flat, layout, params, {})
    return new


def _copy_tree(t):
    if isinstance(t, dict):
        return {k: _copy_tree(v) for k, v in t.items()}
    return t


# ---- writer-side inverse: param tree -> flat get_weights() order -------
# Used by `import_tf --selftest` (write->read->assign round trip through
# the TensorBundle codec) and to EXPORT params trained here back to a
# TF-loadable Model.save_weights bundle.

_P2P_ATTRS = {"w": "kernel", "b": "bias", "gamma": "gamma", "beta": "beta",
              "moving_mean": "moving_mean", "moving_var": "moving_variance"}


def _leaf(tree, path: str):
    node = tree
    for q in path.split("/"):
        node = node[q]
    return node


def extract_flat_weights(net: str, params, **layout_kw):
    """Returns (flat weight list, Keras attribute list) in get_weights()
    order for a resnet/unet/discriminator param tree — the exact inverse
    of assign_flat_weights."""
    layout = _LAYOUTS[net](**layout_kw)
    flat = [np.asarray(_leaf(params, path)) for path, _ in layout]
    return flat, [kind for _, kind in layout]


def extract_pix2pix_weights(which: str, params, bn_state,
                            image_size: int = 128):
    """(flat, attrs) for the pix2pix nets, BN running stats interleaved in
    Keras order — inverse of assign_flat_weights_bn."""
    layout = pix2pix_gen_layout(image_size) if which == "gen" \
        else pix2pix_disc_layout()
    flat = [np.asarray(_leaf(params if tree == "p" else bn_state, path))
            for tree, path in layout]
    return flat, [_P2P_ATTRS[path.rsplit("/", 1)[-1]] for _, path in layout]
