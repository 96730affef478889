"""Eval, inference and sampling, port of ``sggan_tpu/train/evaluate.py``:
output sharpening, the generator forward under the config's compute dtype
and the test-time input convention (``generate``, also the service's),
the epoch-end eval with fake PNG dumps, confusion-matrix scores and
TensorBoard scalars (``test_during_train``), the inference CLI
(``run_test``) and the sample dump (``sample_model``).

The loop functions take the trainer (``tr``: its ``cfg``, ``state``,
``device``, dataset ``root``, ``max_src_hw`` and eval caches), as the JAX
ones do.  Under ``--loss_mode cycle`` they run the generator of
``--which_direction``; under ``--gen_ema`` the EMA shadow, not the
trained parameters (``eval_generator``).  Every net runs in inference
mode: the pix2pix generator's batch norms on the moving stats of the
train state (``state.gen_bn``), under ``--gen_ema`` too, and no dropout.
In a data-parallel job only the coordinator evaluates and samples
(evaluate.py:120-124): the parameters are the same on every rank.
Under ``--eval_crf`` the epoch-end eval refines each fake's three
channels with the dense CRF against the input photo on the host
(``metrics/crf.py``) before it scores them (evaluate.py:166-189).
"""

from __future__ import annotations

import copy
import math
import os
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.loader import load_test_triplet, test_files
from ..data.preprocess import fake_u8, preprocess_test, seg_labels_u8
from ..metrics.crf import dense_crf
from ..metrics.scores import scores, scores_seg_fake
from ..utils import checkpoint as ckpt
from ..utils.cuda_graph import ForwardGraphs
from ..utils.images import imsave, merge, save_images
from ..utils.summary import SummaryWriter
from .step import new_generator, pad_free_head


def sharpen(y: torch.Tensor, t: float) -> torch.Tensor:
    """Eval-time sharpening (--eval_sharpen): tanh(t * atanh(y)) in f32;
    t=inf is the sign limit (exact zeros stay 0, as in the JAX package)."""
    y = y.float()
    if math.isinf(t):
        return torch.sign(y)
    safe = torch.clamp(y, -1.0 + 1e-6, 1.0 - 1e-6)
    return torch.tanh(t * torch.atanh(safe))


def compute_dtype(cfg: Config) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def build_generator(cfg: Config) -> torch.nn.Module:
    """The generator ``cfg`` selects (``models.build``), fresh-initialised
    from ``cfg.data_seed`` on the CPU, as ``step.init_state`` draws it."""
    return new_generator(cfg, torch.Generator().manual_seed(cfg.data_seed))


def gen_forward(cfg: Config, gen: torch.nn.Module, x: torch.Tensor,
                gen_bn: Optional[dict] = None) -> torch.Tensor:
    """The generator's inference forward (evaluate.py:47-63): no dropout;
    the pix2pix batch norms on ``gen_bn``'s moving stats (None: the net
    has no batch norm); the ResNet head that ``step.pad_free_head`` picks
    from the config, without ``--remat`` (nothing is recorded)."""
    return gen(x, {} if gen_bn is None else gen_bn, compute_dtype(cfg),
               pad_free_head=pad_free_head(cfg))[0]


@torch.inference_mode()
def generate(cfg: Config, gen: torch.nn.Module, images01,
             device: torch.device, as_u8: bool = False,
             gen_bn: Optional[dict] = None,
             graphs: Optional[ForwardGraphs] = None) -> np.ndarray:
    """Generator forward on [0, 1]-range NHWC images (a numpy array, or a
    tensor, which stays on the device), honouring the test-time
    input-scale flag (``round(x * 255)`` under ``--test_uint8_input``,
    half to even as numpy rounds) and ``--eval_sharpen``.  Returns the f32
    [-1, 1] output on the host, or with ``as_u8`` its uint8 conversion
    made on the device by ``fake_u8`` (bit-exact to the host
    ``inverse_transform``, a quarter of the bytes to copy).

    With ``graphs`` and a CUDA ``device``, the whole of it from the
    uploaded input to that output runs as one CUDA graph per input shape
    (``utils.cuda_graph.ForwardGraphs``): the analog of the JAX package's
    jitted forward (``tr._gen_jit``), captured again when a weight or a
    batch norm's stats moved to another tensor."""
    if isinstance(images01, torch.Tensor):
        x = images01.to(device=device, dtype=torch.float32)
    else:
        x = torch.as_tensor(np.asarray(images01, np.float32)).to(device)

    def forward(x):
        if cfg.test_uint8_input:
            x = torch.round(x * 255.0)
        y = gen_forward(cfg, gen, x, gen_bn)
        if cfg.eval_sharpen != 1.0:
            y = sharpen(y, cfg.eval_sharpen)
        return fake_u8(y) if as_u8 else y

    if graphs is None or x.device.type != "cuda":
        return forward(x).cpu().numpy()
    weights = [*gen.parameters(), *gen.buffers(),
               *(t for v in (gen_bn or {}).values() for t in v.values())]
    return graphs(forward, (x,), (id(gen), as_u8), weights).cpu().numpy()


def eval_generator(tr) -> torch.nn.Module:
    """The generator that eval, test and sampling run: under
    ``--loss_mode cycle`` the one of ``--which_direction``, ``a2b`` for
    AtoB (the default) and ``b2a`` for BtoA (evaluate.py:50-53); under
    ``--gen_ema`` a copy of that net holding its EMA shadow
    (evaluate.py:101-103), refreshed at each call; else the trained
    net."""
    gen, ema, prefix = tr.state.gen_params, tr.state.ema, ""
    if tr.cfg.loss_mode == "cycle":
        key = "a2b" if tr.cfg.which_direction == "AtoB" else "b2a"
        gen, prefix = gen[key], key + "."
    if ema is None:
        return gen
    if tr._ema_gen is None:
        tr._ema_gen = copy.deepcopy(gen).requires_grad_(False)
    with torch.no_grad():
        for k, p in tr._ema_gen.named_parameters():
            p.copy_(ema[prefix + k])
    return tr._ema_gen


def _upload(tr, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(tr.device)
            for a in arrays]


def _test_inputs(tr, trips):
    """(img, seg) in [0, 1] at the configured size, on the device, of a
    list of decoded test triplets."""
    cfg = tr.cfg
    img_u8, seg_u8 = _upload(tr, np.stack([t[0] for t in trips]),
                             np.stack([t[1] for t in trips]))
    img, seg, _, _ = preprocess_test(
        img_u8, seg_u8, None, out_hw=cfg.image_size, mask_hw=cfg.mask_hw,
        n_class=cfg.segment_class, with_masks=False)
    return img, seg


def test_during_train(tr, epoch: int,
                      writer: Optional[SummaryWriter] = None):
    """Epoch-end eval, parity with model.py:307-378 (evaluate.py:119): the
    test split in chunks of up to 8, the ragged tail padded with the last
    triplet (outputs sliced off); per file the fake's PNG in --test_dir and
    its argmax labels against the seg's; aggregate scores; TensorBoard
    scalars under the reference's tags.  The ground-truth labels are
    pulled once per run (cached by chunk paths and size).  Returns
    (fakes as (N, H, W, 3) uint8, score dict), or (None, None) without
    test files, or on a rank other than the coordinator.  Under
    ``--eval_crf`` the input photos come to the host too, and each fake
    is refined with the dense CRF against its photo before it is scored
    (its PNG is the generator's)."""
    cfg = tr.cfg
    if not tr.is_coord:
        return None, None
    files = test_files(tr.root)
    if not files:
        return None, None
    os.makedirs(cfg.test_dir, exist_ok=True)
    gen = eval_generator(tr)
    gts, preds, outputs = [], [], []
    chunk = min(8, len(files))
    for c0 in range(0, len(files), chunk):
        paths = files[c0:c0 + chunk]
        trips = [load_test_triplet(p, cache_mb=cfg.decode_cache_mb,
                                   max_hw=tr.max_src_hw)
                 for p in paths]
        trips += [trips[-1]] * (chunk - len(paths))
        img, seg = _test_inputs(tr, trips)
        fakes = generate(cfg, gen, img, tr.device, as_u8=True,
                         gen_bn=tr.state.gen_bn, graphs=tr.fwd_graphs)
        seg_key = (tuple(paths), cfg.image_size)
        seg_np = tr._eval_seg_cache.get(seg_key)
        if seg_np is None:
            seg_np = seg_labels_u8(seg).cpu().numpy()
            tr._eval_seg_cache[seg_key] = seg_np
        if cfg.eval_crf:
            img_np = img.cpu().numpy()
        for i, path in enumerate(paths):
            fake = fakes[i:i + 1]
            imsave(fake, [1, 1], os.path.join(cfg.test_dir,
                                              os.path.basename(path)))
            fake_img = merge(fake, [1, 1])
            fake_img = fake_img.reshape(1, *fake_img.shape)
            outputs.append(fake_img[0])
            if cfg.eval_crf:
                # the fake's channels as (C, H, W) scores in [0, 1],
                # refined against the photo (the reference's dormant
                # get_labels(crf=True), model.py:278-305)
                q = dense_crf((img_np[i] * 255).astype(np.uint8),
                              np.ascontiguousarray(fake_img[0].astype(
                                  np.float32).transpose(2, 0, 1) / 255.0))
                fake_img = (np.ascontiguousarray(q.transpose(1, 2, 0))[None]
                            * 255).astype(np.uint8)
            lt, lp = scores_seg_fake(
                seg_np[i:i + 1], fake_img,
                compat_eval_overflow=cfg.compat_eval_overflow)
            gts += list(lt)
            preds += list(lp)
    score = scores(gts, preds, n_class=cfg.segment_class)
    if writer is not None:
        writer.scalar("Overall Accuracy", score["Overall Acc"], epoch)
        writer.scalar("Mean Accuracy", score["Mean Acc"], epoch)
        writer.scalar("Frequency Weighted Accuracy", score["FreqW Acc"],
                      epoch)
        writer.scalar("Mean IoU", score["Mean IoU"], epoch)
    return np.stack(outputs), score


def run_test(tr) -> None:
    """Inference CLI, parity with model.py:535-567 (evaluate.py:202): load
    the latest checkpoint, translate every testA image, save the fake as
    <name> and the input as real_<name> in --test_dir; the coordinator's
    work alone in a data-parallel job."""
    cfg = tr.cfg
    if not tr.is_coord:
        return
    loaded = ckpt.source(cfg.checkpoint_dir, cfg.dataset_dir)
    restored = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir,
                         pool=False)
    if restored is not None:
        tr.state = restored
        print(f" [*] Load SUCCESS ({loaded})")
    else:
        print(" [!] Load failed...")
    os.makedirs(cfg.test_dir, exist_ok=True)
    gen = eval_generator(tr)
    for path in test_files(tr.root):
        print("Processing image: " + path)
        img, _ = _test_inputs(tr, [load_test_triplet(path)])
        fake = generate(cfg, gen, img, tr.device, as_u8=True,
                        gen_bn=tr.state.gen_bn, graphs=tr.fwd_graphs)
        base = os.path.basename(path)
        # the reference saves the real copy through inverse_transform of
        # [0, 1]-range data (model.py:566): reproduced exactly
        save_images(img.cpu().numpy() * 2.0 - 1.0, [1, 1],
                    os.path.join(cfg.test_dir, "real_" + base))
        imsave(fake, [1, 1], os.path.join(cfg.test_dir, base))


def sample_model(tr, epoch: int, idx: int) -> None:
    """Sample dump, parity with model.py:506-525 (evaluate.py:232): a
    batch of shuffled test images translated into one JPEG grid in
    --sample_dir (the coordinator's alone)."""
    cfg = tr.cfg
    files = test_files(tr.root)
    if not files or not tr.is_coord:
        return
    rng = np.random.default_rng(cfg.data_seed + epoch * 10000 + idx)
    rng.shuffle(files)
    paths = files[: cfg.batch_size]
    img, _ = _test_inputs(tr, [load_test_triplet(
        p, cache_mb=cfg.decode_cache_mb, max_hw=tr.max_src_hw)
        for p in paths])
    fake = generate(cfg, eval_generator(tr), img, tr.device, as_u8=True,
                    gen_bn=tr.state.gen_bn, graphs=tr.fwd_graphs)
    os.makedirs(cfg.sample_dir, exist_ok=True)
    name = os.path.basename(paths[0]).split(".")[0]
    imsave(fake, [fake.shape[0], 1],
           f"{cfg.sample_dir}/A_{epoch:02d}_{idx:04d}_{name}.jpg")
