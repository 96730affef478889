"""Host image IO and conversion: the port's own copy of
``sggan_tpu/utils/images.py`` (numpy and PIL only), held to it by
``tests/test_torch_data.py``, so the port imports nothing of the JAX
package.  The text below is the JAX module's.

Host-side image IO and conversion utilities — parity with the
reference's utils.py:239-314 (save/merge/inverse_transform/get_img) and
utils.py:158-165 (one_hot), using PIL instead of skimage.io.

These run on the host only; all per-pixel *compute* (resize, one-hot at
training resolution, normalization, flips) happens device-side in
data/preprocess.py.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def imread(path, is_grayscale: bool = False) -> np.ndarray:
    """PNG/JPG decode to uint8 ndarray (H, W[, C]) — utils.py:249-254."""
    img = Image.open(path)
    if is_grayscale:
        return np.asarray(img.convert("F"), dtype=np.float64) / 255.0
    return np.asarray(img)


def inverse_transform(images) -> np.ndarray:
    """[-1, 1] float -> uint8, ((x+1)/2*255).astype(uint8) with the
    reference's truncating cast (utils.py:300-314).  Deviation, on
    purpose: this computes in float64; the reference evaluates the same
    formula in float32 (its input is a float32 numpy array and python
    scalars don't upcast), which can land one code below at pixels
    sitting exactly on the x = 2k/255 - 1 lattice (f32 rounding of the
    product dips just under the integer; measured 32 mismatches in a 4M+
    lattice sample, never elsewhere).  f64 is kept as the repo-wide
    convention — the device twin data/preprocess.py::fake_u8 is proven
    bit-exact against THIS function, and real generator outputs don't
    sit on the lattice."""
    return (((np.asarray(images, np.float64) + 1.0) / 2.0) * 255).astype(np.uint8)


def merge(images, size) -> np.ndarray:
    """Grid compositor (utils.py:261-269): images (N, H, W, 3) tiled into a
    (size[0]*H, size[1]*W, 3) uint8 canvas, row-major."""
    images = np.asarray(images)
    h, w = images.shape[1], images.shape[2]
    img = np.zeros((h * size[0], w * size[1], 3))
    for idx, image in enumerate(images):
        i = idx % size[1]
        j = idx // size[1]
        img[j * h:j * h + h, i * w:i * w + w, :] = image[..., :3]
    return img.astype(np.uint8)


def imsave(images, size, path):
    """utils.py:271-277."""
    Image.fromarray(merge(images, size)).save(path)


def save_images(images, size, image_path):
    """utils.py:239-241: inverse-transform then save as a grid."""
    return imsave(inverse_transform(images), size, image_path)


def get_img(image, size) -> np.ndarray:
    """utils.py:243-247: merged grid reshaped to (1, H, W, 3)."""
    img = merge(inverse_transform(image), size)
    return img.reshape(1, *img.shape)


def merge_images(images, size) -> np.ndarray:
    """Legacy alias (utils.py:257-258)."""
    return inverse_transform(images)


def plot_tensors(t1, t2, title, name1, name2):
    """Side-by-side label plot (debug scaffolding, utils.py:316-327)."""
    import matplotlib.pyplot as plt
    fig = plt.figure(1)
    ax1 = plt.subplot(1, 2, 1)
    plt.imshow(t1)
    ax1.set_title(name1)
    ax2 = plt.subplot(1, 2, 2)
    plt.imshow(t2)
    ax2.set_title(name2)
    fig.suptitle(title)
    plt.show()


def center_crop(x, crop_h, crop_w=None, resize_h=64, resize_w=64):
    """Legacy center-crop+resize (utils.py:280-289), PIL instead of
    scipy.misc.imresize."""
    if crop_w is None:
        crop_w = crop_h
    h, w = x.shape[:2]
    j = int(round((h - crop_h) / 2.0))
    i = int(round((w - crop_w) / 2.0))
    patch = np.asarray(x)[j:j + crop_h, i:i + crop_w]
    img = Image.fromarray(patch.astype(np.uint8))
    return np.asarray(img.resize((resize_w, resize_h), Image.BILINEAR))


def transform(image, npx: int = 64, is_crop: bool = True, resize_w: int = 64):
    """Legacy transform (utils.py:291-298): optional center crop then
    scale to [-1, 1] via x*2 - 1."""
    cropped = center_crop(image, npx, resize_w=resize_w) if is_crop else image
    return np.array(cropped) * 2 - 1.0


def one_hot(image_in: np.ndarray, num_classes: int = 8) -> np.ndarray:
    """Host one-hot of a (H, W) class-id map — utils.py:158-165.
    (Training-path one-hot happens on device; this is the offline/test
    helper with reference parity.)"""
    hot = np.zeros((*image_in.shape[:2], num_classes), np.int64)
    idx = np.clip(image_in.astype(np.int64), 0, num_classes - 1)
    h_idx, w_idx = np.meshgrid(np.arange(hot.shape[0]),
                               np.arange(hot.shape[1]), indexing="ij")
    hot[h_idx, w_idx, idx] = 1
    return hot
