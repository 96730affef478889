"""Typed configuration + CLI of the port: its own copy of
``sggan_tpu/config.py``, with every field, default and flag the same
(``tests/test_torch_config.py`` holds the two together), so the port
imports nothing of the JAX package.  The text below is the JAX module's.

Mirrors the reference CLI flag-for-flag (reference: main.py:13-44) so the
public surface matches, and *wires the dormant flags for real*:

* ``lr`` actually sets the learning rate (the reference overrides it to
  1e-3 at model.py:82,205);
* ``epoch_step`` drives linear LR decay (commented out at model.py:223);
* ``use_lsgan`` selects the LSGAN (MSE) vs sigmoid-CE criterion in the
  *active* loss path (reference selects it at model.py:64-67 but the train
  step ignores it, model.py:190-191);
* ``L1_lambda`` / ``Lg_lambda`` / ``max_size`` feed the full SG-GAN loss and
  the functional image pool.

Booleans are proper ``--flag/--no-flag`` switches instead of the
``type=bool`` argparse footgun in the reference.

Extra TPU-native knobs are grouped at the bottom (mesh shape, dtypes,
loss-mode selection) — these have no reference counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # ---- reference flags (main.py:13-44), same names and defaults ----
    dataset_dir: str = "city"
    epoch: int = 100
    epoch_step: int = 100              # epochs before linear LR decay starts
    batch_size: int = 1
    train_size: int = int(1e8)
    image_height: int = 128            # reference default is 64, but the
    image_width: int = 128             # discriminator stack only works >=128
    #                                    (see SURVEY §3.4); we default to the
    #                                    working resolution.
    ratio_gan2seg: int = 10
    use_augmentation: bool = True
    ngf: int = 64
    ndf: int = 64
    input_nc: int = 3
    output_nc: int = 3
    lr: float = 2e-4
    beta1: float = 0.5
    which_direction: str = "AtoB"
    phase: str = "train"
    save_freq: int = 1000
    print_freq: int = 5
    continue_train: bool = False
    checkpoint_dir: str = "./checkpoint"
    sample_dir: str = "./sample"
    test_dir: str = "./test"
    L1_lambda: float = 10.0
    Lg_lambda: float = 5.0
    use_resnet: bool = False
    use_lsgan: bool = True
    use_pix2pix: bool = False
    max_size: int = 50
    segment_class: int = 34

    # ---- reference behavioural quirks, made explicit ----
    # The reference hard-codes lr=1e-3 regardless of --lr (model.py:205-207).
    # `compat_lr_override=True` reproduces that; False honours --lr + decay.
    compat_lr_override: bool = True
    # Keras models in the reference are called without training=True, so
    # Dropout never fires (model.py:173 etc.).  "intended" enables dropout
    # during training as the architecture intends; "keras_quirk" reproduces
    # the reference's silently-disabled dropout.
    dropout_mode: str = "intended"     # "intended" | "keras_quirk"
    # Mask grid stride.  The reference is self-contradictory (H/8 at
    # model.py:97 vs H/34 at module.py:282 vs the loader's ~H/32 zoom at
    # utils.py:197); we standardize on the paper's stride-8 grid.
    mask_stride: int = 8
    # The reference feeds the generator 0-255-range floats at TEST time
    # (tf.image.convert_image_dtype to uint8 then float, model.py:555-557)
    # but [0,1]-range floats at TRAIN time — a train/test input-scale
    # mismatch (SURVEY §3.2).  True reproduces it; False feeds [0,1].
    test_uint8_input: bool = True
    # The reference's eval multiplies the already-uint8 fake by 255 before
    # argmax (metric.py:75), wrapping mod 256 — True reproduces the wrap so
    # scores are comparable to reference-produced numbers; False argmaxes
    # the raw channels (the obvious intent).
    compat_eval_overflow: bool = False
    # The reference's non-p2p train step accumulates fake batches by
    # concatenation up to 10 entries then resets (model.py:175-179) — an
    # inline ImagePool substitute with different dynamics (the D sees the
    # same growing history every step).  True reproduces those dynamics as
    # a fixed-shape 10-slot FIFO-with-reset in loss_mode="p2p"; False (the
    # default) uses the current fake, which is what the reference's p2p
    # losses actually consume.
    compat_fake_history: bool = False

    # ---- loss / trainer mode ----
    # "p2p"  — the reference's *active* path: BCE GAN + 100·L1 (model.py:149-166)
    # "sggan" — the full SG-GAN objective the repo carries dormant:
    #           criterionGAN (LSGAN/SCE) + L1_lambda·L1 + Lg_lambda·gradloss
    #           with the semantic boundary-weight map (model.py:114-133),
    #           image pool on the discriminator's fake batch.
    # "cycle" — two-generator cycle-consistency training (train/cycle.py);
    #           needs trainB/trainB_seg/trainB_seg_class alongside trainA.
    # "simple" — the reference's dormant sce losses with 1/ratio_gan2seg
    #           GAN weighting (model.py:135-147), wired for real.
    loss_mode: str = "p2p"
    # L1 anchor for loss_mode="sggan".  "real" reproduces the dormant
    # generator_loss exactly: L1(real_A, fake) (model.py:122, CycleGAN
    # photo-to-photo lineage) — which conflicts with the seg_A
    # discriminator real-branch and collapses training (QUALITY.md).
    # "seg" anchors to seg_A like the active p2p loss (model.py:155),
    # making the full objective consistent with the data pairing.
    sggan_l1_target: str = "real"      # "real" (faithful) | "seg"
    identity_lambda: float = 5.0       # identity term weight in cycle mode
    # Dense-CRF refinement of eval predictions (the reference builds this
    # machinery, metric.py:49-69 + model.py:278-305, but leaves the call
    # sites commented out; this wires it for real).
    eval_crf: bool = False
    # Eval-time output sharpening temperature T: fakes are remapped
    # fake' = tanh(T * atanh(fake)) before scoring/saving (T=inf is the
    # np.sign hardening limit).  1.0 disables (default).  QUALITY.md's
    # frontier sweep: moderate T raises Overall Acc AND Mean IoU
    # together on calibrated checkpoints (the reference's 3-channel-
    # argmax metric, metric.py:71-77, rewards decisive channel races);
    # large T trades per-class coverage for OA.  Applies to
    # eval/test/serving outputs only — training is unaffected.
    eval_sharpen: float = 1.0
    # Photometric augmentation — the imgaug seq1 pipeline the reference
    # builds but never applies (utils.py:57-73: blur/contrast/additive
    # noise/brightness).  Realized as PRNG-keyed device-side transforms on
    # the photo only (seg/mask geometry is untouched by photometric ops).
    use_photometric: bool = False
    data_seed: int = 19                # reference: tf.random.set_seed(19), main.py:4

    # ---- TPU-native knobs (no reference counterpart) ----
    compute_dtype: str = "bfloat16"    # conv/matmul compute dtype on TPU
    param_dtype: str = "float32"
    mesh_data: int = 1                 # data-parallel axis size
    mesh_space: int = 1                # spatial-sharding axis size (H plane)
    mesh_space_w: int = 1              # second spatial axis (W plane; 2-D grid)
    donate: bool = True                # donate train-state buffers under jit
    # Rematerialize generator stages in the backward pass (jax.checkpoint):
    # trades ~one extra forward for not storing intra-stage activations,
    # enabling native-resolution (2048x1024) training within one chip's
    # HBM.  Semantic generators (resnet/unet) only.
    remat: bool = False
    # Resnet head form: None = pad-free strided head unless --remat (the
    # pad-free strips cost ~2.8G extra peak HBM at native res; see
    # generator_resnet.apply); explicit True/False overrides.
    pad_free_head: Optional[bool] = None
    use_pallas: Optional[bool] = None  # None = auto (TPU only)
    prefetch: int = 2                  # host->device pipeline depth
    # Decoded-triplet RAM cache budget (MB); epochs >= 2 skip PNG decode
    # entirely.  0 disables.  (This host has 1 CPU core — decode, not the
    # device step, bounds real-data training without the cache.)
    decode_cache_mb: int = 8192
    # Shrink decoded sources on the host to at most this multiple of the
    # target size before upload (box filter; class maps nearest).  The
    # device preprocess resizes to the target anyway; this cuts
    # host->device transfer bytes, which dominate real-data training
    # through a remote device relay.  0 uploads full-resolution sources.
    host_downscale: int = 2
    # HBM budget (MB) for keeping the ENTIRE training split resident on
    # device as uint8 arrays (loader.DeviceDataset): batches become
    # device-side gathers with zero per-step upload.  Used when the
    # (downscaled) split fits the budget, on every rank's card under
    # --mesh_data / --mesh_space; 0 disables.
    device_dataset_mb: int = 2048
    # Train steps per chunk: with the device-resident split the trainer
    # captures one full step (gather + preprocess + draws + step) as a
    # CUDA graph and replays it `scan_steps` times a chunk, the analog of
    # the JAX package's lax.scan of K steps (train/fused.py).  The draws
    # are an eager step's, so every value trains the same steps.  Saves
    # and prints happen at chunk granularity.  Under several ranks over
    # NCCL the graph holds the step's collectives; over gloo the steps of
    # a chunk run eagerly (a gloo collective is not captured).
    # 1 = the eager step, one dispatch per op.
    scan_steps: int = 8
    # EMA decay for a shadow copy of the generator params (0 disables).
    # A standard GAN stabilization lever with no reference counterpart:
    # training updates the raw generator, eval/test/serving read the
    # exponentially-averaged one.  One cheap fused elementwise pass per
    # step; supported for every loss mode and mesh kind (the cycle
    # shadow covers BOTH generators; under shard_map the update runs on
    # the pmean'd-gradient params, so the shadow stays replica-
    # identical).
    gen_ema: float = 0.0
    # When set, the trainer traces a short window of train dispatches
    # with jax.profiler into this directory (first dispatch excluded so
    # compile stays out of the trace) and logs a per-epoch Images/sec
    # scalar.  Empty disables.  (SURVEY §5: the reference has no
    # tracing/profiling at all.)
    profile_dir: str = ""
    # Evaluate (test_during_train) every Nth epoch instead of every
    # epoch (reference behavior = 1, model.py:264).  Through this
    # environment's remote relay the 3-convention eval + its compile
    # dominates short-run wall clock (QUALITY.md) — raising this trades
    # curve resolution for wall time.  The final epoch always evals.
    eval_freq: int = 1
    log_dir: str = "logs"

    # ---- derived ----
    @property
    def image_size(self) -> Tuple[int, int]:
        return (self.image_height, self.image_width)

    @property
    def mask_hw(self) -> Tuple[int, int]:
        return (self.image_height // self.mask_stride,
                self.image_width // self.mask_stride)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "Config":
        """Raise early with actionable messages (the reference fails deep
        inside TF with shape errors instead — SURVEY §3.4)."""
        if self.image_height % self.mask_stride or \
                self.image_width % self.mask_stride:
            raise ValueError(
                f"image size {self.image_size} must be divisible by "
                f"mask_stride={self.mask_stride}")
        if self.phase == "train" and not self.use_pix2pix:
            # three stride-2 convs in the semantic discriminator
            if self.image_height % 8 or self.image_width % 8:
                raise ValueError(
                    f"image size {self.image_size} must be divisible by 8 "
                    "for the semantic discriminator")
        if self.mesh_space > 1:
            per = self.image_height // self.mesh_space
            if self.image_height % self.mesh_space or per % 8:
                raise ValueError(
                    f"image_height={self.image_height} must split into "
                    f"mesh_space={self.mesh_space} shards of a multiple "
                    "of 8 rows")
        if self.mesh_space_w > 1:
            if self.mesh_space <= 1:
                raise ValueError(
                    "mesh_space_w>1 requires mesh_space>1 (the W axis "
                    "extends the H shard grid)")
            per_w = self.image_width // self.mesh_space_w
            if self.image_width % self.mesh_space_w or per_w % 8:
                raise ValueError(
                    f"image_width={self.image_width} must split into "
                    f"mesh_space_w={self.mesh_space_w} shards of a "
                    "multiple of 8 columns")
        if self.mesh_data > 1:
            eff = self.batch_size * (2 if self.use_augmentation else 1)
            if eff % self.mesh_data:
                raise ValueError(
                    f"effective batch {eff} (batch_size"
                    f"{' x2 augmentation' if self.use_augmentation else ''})"
                    f" must divide by mesh_data={self.mesh_data}")
        if self.loss_mode == "cycle" and self.use_pix2pix:
            raise ValueError("loss_mode=cycle uses the semantic nets; "
                             "drop --use_pix2pix")
        if self.scan_steps < 1:
            raise ValueError("scan_steps must be >= 1")
        if self.eval_freq < 1:
            raise ValueError("eval_freq must be >= 1")
        if self.sggan_l1_target not in ("real", "seg"):
            # argparse enforces choices; programmatic Configs must not be
            # able to fall through to the collapsing "real" anchor silently
            raise ValueError(
                f"sggan_l1_target={self.sggan_l1_target!r} — must be "
                "'real' (faithful to model.py:122) or 'seg' (consistent "
                "with the seg_A discriminator pairing)")
        if self.loss_mode not in ("p2p", "sggan", "cycle", "simple"):
            raise ValueError(f"loss_mode={self.loss_mode!r} — must be one "
                             "of p2p/sggan/cycle/simple")
        if self.dropout_mode not in ("intended", "keras_quirk"):
            raise ValueError(f"dropout_mode={self.dropout_mode!r} — must "
                             "be 'intended' or 'keras_quirk'")
        if self.gen_ema:
            if not (0.0 < self.gen_ema < 1.0):
                raise ValueError(f"gen_ema={self.gen_ema} must be in (0,1)")
        if not self.eval_sharpen >= 1.0:  # NaN also fails this
            raise ValueError(
                f"eval_sharpen={self.eval_sharpen} must be >= 1.0 "
                "(1 = off, inf = hard sign saturation)")
        if self.compat_fake_history and (
                self.mesh_data > 1 or self.mesh_space > 1):
            # the concat-to-10-then-reset history reproduces single-device
            # training dynamics; a sharded pool would change them
            raise ValueError(
                "compat_fake_history reproduces a single-device training-"
                "dynamics quirk (model.py:175-179); run it with "
                "mesh_data=mesh_space=1")
        return self


def _add_bool(p: argparse.ArgumentParser, name: str, default: bool, help: str):
    p.add_argument(f"--{name}", dest=name, action=argparse.BooleanOptionalAction,
                   default=default, help=help)


def build_parser() -> argparse.ArgumentParser:
    d = Config()
    p = argparse.ArgumentParser(
        description="sggan_tpu_torch — the PyTorch/CUDA port of sggan_tpu "
                    "(parity with reference main.py)")
    p.add_argument("--dataset_dir", default=d.dataset_dir, help="path of the dataset")
    p.add_argument("--epoch", type=int, default=d.epoch, help="# of epoch")
    p.add_argument("--epoch_step", type=int, default=d.epoch_step, help="# of epoch to decay lr")
    p.add_argument("--batch_size", type=int, default=d.batch_size, help="# images in batch")
    p.add_argument("--train_size", type=int, default=d.train_size, help="# images used to train")
    p.add_argument("--img_height", dest="image_height", type=int, default=d.image_height, help="image height")
    p.add_argument("--img_width", dest="image_width", type=int, default=d.image_width, help="image width")
    p.add_argument("--ratio_gan2seg", type=int, default=d.ratio_gan2seg, help="ratio of gan loss to seg loss")
    _add_bool(p, "use_augmentation", d.use_augmentation, "enable/disable data augmentation")
    p.add_argument("--ngf", type=int, default=d.ngf, help="# of gen filters in first conv layer")
    p.add_argument("--ndf", type=int, default=d.ndf, help="# of discri filters in first conv layer")
    p.add_argument("--input_nc", type=int, default=d.input_nc, help="# of input image channels")
    p.add_argument("--output_nc", type=int, default=d.output_nc, help="# of output image channels")
    p.add_argument("--lr", type=float, default=d.lr, help="initial learning rate for adam")
    p.add_argument("--beta1", type=float, default=d.beta1, help="momentum term of adam")
    p.add_argument("--which_direction", default=d.which_direction, help="AtoB or BtoA")
    p.add_argument("--phase", default=d.phase, help="train, test")
    p.add_argument("--save_freq", type=int, default=d.save_freq, help="save a model every save_freq iterations")
    p.add_argument("--print_freq", type=int, default=d.print_freq, help="print debug info every print_freq iterations")
    _add_bool(p, "continue_train", d.continue_train, "continue training from the latest checkpoint")
    p.add_argument("--checkpoint_dir", default=d.checkpoint_dir, help="models are saved here")
    p.add_argument("--sample_dir", default=d.sample_dir, help="samples are saved here")
    p.add_argument("--test_dir", default=d.test_dir, help="test samples are saved here")
    p.add_argument("--L1_lambda", type=float, default=d.L1_lambda, help="weight on L1 term in objective")
    p.add_argument("--Lg_lambda", type=float, default=d.Lg_lambda, help="weight on gradloss term in objective")
    _add_bool(p, "use_resnet", d.use_resnet, "generator network using residual blocks")
    _add_bool(p, "use_lsgan", d.use_lsgan, "gan loss defined in lsgan")
    _add_bool(p, "use_pix2pix", d.use_pix2pix, "pix2pix generator and discriminator")
    p.add_argument("--max_size", type=int, default=d.max_size, help="max size of image pool, 0 disables the pool")
    p.add_argument("--segment_class", type=int, default=d.segment_class, help="number of segmentation classes")
    # --- extensions ---
    _add_bool(p, "compat_lr_override", d.compat_lr_override,
              "reproduce the reference's hard-coded lr=1e-3 (model.py:205)")
    p.add_argument("--dropout_mode", default=d.dropout_mode, choices=["intended", "keras_quirk"])
    p.add_argument("--mask_stride", type=int, default=d.mask_stride)
    _add_bool(p, "test_uint8_input", d.test_uint8_input,
              "reproduce the reference's 0-255-range generator input at test time")
    _add_bool(p, "compat_eval_overflow", d.compat_eval_overflow,
              "reproduce the reference's uint8 wrap before eval argmax (metric.py:75)")
    _add_bool(p, "compat_fake_history", d.compat_fake_history,
              "reproduce the reference's concat-to-10-then-reset fake history (model.py:175-179)")
    _add_bool(p, "use_photometric", d.use_photometric,
              "photometric augmentation (the reference's dormant imgaug seq1)")
    p.add_argument("--loss_mode", default=d.loss_mode, choices=["p2p", "sggan", "cycle", "simple"])
    p.add_argument("--sggan_l1_target", default=d.sggan_l1_target,
                   choices=["real", "seg"],
                   help="sggan-mode L1 anchor: 'real' = the reference's "
                        "dormant code (model.py:122), 'seg' = consistent "
                        "with the seg_A discriminator pairing")
    p.add_argument("--identity_lambda", type=float, default=d.identity_lambda)
    _add_bool(p, "eval_crf", d.eval_crf,
              "apply dense-CRF refinement to eval predictions")
    p.add_argument("--eval_sharpen", type=float, default=d.eval_sharpen,
                   help="eval-time output sharpening temperature "
                        "tanh(T*atanh(fake)); 1 = off, 'inf' = hard "
                        "saturation (QUALITY.md OA/IoU frontier)")
    p.add_argument("--data_seed", type=int, default=d.data_seed)
    p.add_argument("--compute_dtype", default=d.compute_dtype, choices=["bfloat16", "float32"])
    p.add_argument("--mesh_data", type=int, default=d.mesh_data, help="data-parallel mesh axis size")
    p.add_argument("--mesh_space", type=int, default=d.mesh_space, help="spatial mesh axis size")
    p.add_argument("--mesh_space_w", type=int, default=d.mesh_space_w, help="second spatial mesh axis (W plane; 2-D shard grid)")
    _add_bool(p, "donate", d.donate, "donate train-state buffers under jit")
    _add_bool(p, "remat", d.remat,
              "rematerialize generator stages in backward (less HBM, "
              "~1 extra forward) — for native-resolution training")
    p.add_argument("--pad_free_head", type=lambda s: s.lower() == "true",
                   default=d.pad_free_head,
                   help="resnet head form: true=pad-free strided head "
                        "(faster), false=pre-padded (lower peak HBM); "
                        "default auto (pad-free unless --remat)")
    p.add_argument("--decode_cache_mb", type=int, default=d.decode_cache_mb,
                   help="decoded-image RAM cache budget (MB), 0 disables")
    p.add_argument("--host_downscale", type=int, default=d.host_downscale,
                   help="host-side source downscale cap (x target size), 0 = full res")
    p.add_argument("--device_dataset_mb", type=int, default=d.device_dataset_mb,
                   help="HBM budget for a device-resident training split, 0 disables")
    p.add_argument("--scan_steps", type=int, default=d.scan_steps,
                   help="train steps per chunk over the device-resident "
                        "split, replays of one CUDA graph of the step "
                        "(eager steps over gloo's ranks); 1 = "
                        "the eager step.  NOTE: with K>1, --print_freq output "
                        "and --save_freq checkpoints land on K-step chunk "
                        "boundaries rather than exact steps")
    p.add_argument("--gen_ema", type=float, default=d.gen_ema,
                   help="EMA decay for a shadow generator used at "
                        "eval/test/serving; 0 disables")
    p.add_argument("--eval_freq", type=int, default=d.eval_freq,
                   help="run the epoch-end eval every N epochs (1 = every "
                        "epoch, the reference behavior; the final epoch "
                        "always evals)")
    p.add_argument("--profile_dir", default=d.profile_dir,
                   help="jax.profiler trace dir for a short train-step "
                        "window; empty disables")
    p.add_argument("--log_dir", default=d.log_dir)
    return p


def config_from_namespace(ns) -> Config:
    """Config from an argparse namespace, ignoring non-Config extras —
    the one filtering point for every CLI that extends build_parser()."""
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(ns).items() if k in fields})


def parse_args(argv=None) -> Config:
    return config_from_namespace(build_parser().parse_args(argv))
