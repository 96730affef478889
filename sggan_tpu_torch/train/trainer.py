"""Training and eval orchestration, port of ``sggan_tpu/train/trainer.py``
(parity with the reference's ``sggan`` class, model.py:39-567), on one
device, or on one card in each rank of a data-parallel job.

Per epoch (model.py:219-271): the learning rate of ``lr_schedule``; the
steps, over the split resident on the device (``train/fused.py``) when it
fits ``--device_dataset_mb``, else over the host iterator (PNG decode on a
prefetch thread, upload, preprocess on the device); the print line of
the reference; the epoch-end eval over testA (every ``--eval_freq``
epochs and always the last) with fake PNGs, scores and TensorBoard
scalars; saves every ``--save_freq`` steps, at the end (in ``finally``)
and on KeyboardInterrupt (model.py:272-275).

``--scan_steps K`` runs the resident split in chunks of K steps, each a
replay of one CUDA graph of the whole step, its NCCL collectives inside
under several ranks (eager steps over gloo, whose collectives cannot be
captured), as the JAX package's lax.scan chunks run it
(``train/fused.py``); the graph is captured at the first chunk of
training, after a ``--continue_train`` load.  ``--scan_steps 1``
and the host iterator run the eager step, as the JAX package runs its
per-step path.  The learning rate is a device scalar (``lr``) that each
epoch writes, so a captured step reads each epoch's.

Randomness: the nets are drawn from ``--data_seed`` (``init_state``); the
preprocess's draws and the generator's dropout masks come from a generator
on the device and the pool's from one on the host, both seeded from
``--data_seed``.  jax.random
streams are not reproducible in torch, so a run is not the JAX run.

Checkpoint numbers continue after the one ``--continue_train`` loaded,
so a later resume finds the newest state (the JAX trainer numbers them
from 0 again, below the one it loaded).

Every net the CLI selects trains: the ResNet or U-Net generator with the
semantic discriminator, or the pix2pix pair with its batch-norm state.
``--loss_mode cycle`` trains both generators and both discriminators
(``train/cycle.py``) on two domains: trainA and trainB resident together
when both fit, else two host iterators zipped, trainB's shuffled from
``data_seed + 7919`` (trainer.py:152-197, :322-351).
``--remat`` and ``--pad_free_head`` reach the step and the eval
(``step.pad_free_head``); under ``--scan_steps`` the step's graph holds
the backward's recompute.  ``--compat_fake_history`` trains the
reference's fake history (``train/step.py``), in the step's graph too;
``--eval_crf`` refines the eval's fakes with the dense CRF
(``train/evaluate.py``).

``--mesh_data N`` trains on N ranks, one card each, in a process group
that the caller has joined (``parallel/distributed.py``; ``main`` does it
from ``torchrun``'s environment), and runs the data-parallel step
(``parallel/dp.py``).  A rank's rows of each global batch of B' rows
(``batch_size``, doubled by augmentation) come from one of two paths,
each as its JAX counterpart takes them:

* the split resident on every rank's card (``_maybe_device_dataset``,
  the default), as one JAX process keeps it replicated over its mesh
  (trainer.py:178-182): each rank assembles its block ``[r B'/N, (r + 1)
  B'/N)`` of the batch that one process would assemble, the rows
  ``with_sharding_constraint(batch, P(data))`` gives device r
  (fused.py:99-111; ``fused.make_batch_fn``'s ``rows``), so with
  augmentation the first ranks get plain rows and the last their
  augmented copies; B' must divide by N (the JAX mesh's ``shard_batch``,
  dp.py:56), so ``--mesh_data 2 --batch_size 1`` with augmentation
  trains.  ``--scan_steps K`` runs the JAX scan's chunk loop, its prints
  and saves on chunk boundaries, each step a replay of the step's CUDA
  graph over NCCL (every rank captures it, its collectives inside), an
  eager step over gloo (its collectives run on the host);
* the host iterator, where the split is not resident (an empty budget,
  a split that does not fit, or a rank that cannot build it: the ranks
  agree first, ``dp.agree``), as the JAX trainer feeds several processes
  (trainer.py:49-77, :159): each rank decodes ``batch_size / N`` files
  of each global batch (its rows of the shared shuffle,
  ``process_index``/``process_count``) with their augmented copies, so
  ``batch_size`` must divide by N; eager steps.

On both paths each rank preprocesses its rows with the draws of the
global batch at those rows (``global_b``, ``sample_rows``), so the global
batch is the one-process batch; the paths differ in which rows reach
which rank's pool and batch-norm moments.  Only the coordinator (rank
0) prints, evaluates, samples and writes TensorBoard, while the other
ranks wait at a barrier with a timeout of its own (``dp.wait_group``: an
eval may outlast the collectives' timeout); every rank takes part in a
save, in which rank 0 writes the checkpoint with every rank's pool rows
in the JAX package's global layout; on ``--continue_train`` every rank
reads it and takes its own rows.

``--mesh_space S`` (and ``--mesh_space_w W``) trains the semantic nets
(sggan, cycle) or the pix2pix pair (p2p) spatially sharded
(``parallel/spatial_step.py``) on ``D x S x W`` ranks
(``--mesh_data D``), laid out as ``mesh.grid`` says.  Each rank takes
its data row's rows of each global batch as a rank of a data-parallel
job of D ranks does (the resident block ``[d B'/D, (d + 1) B'/D)``, or
the host iterator's ``batch_size / D`` files), preprocesses them at full
resolution, then keeps its block of the plane
(``spatial_step.shard_batch``), as ``_batch_spec`` places a resident
batch and the JAX trainer's ``shard_sp_batch`` splits a host's rows
(trainer.py:79-105).  The pool's draws are the data row's, the dropout
masks the shard's.  As under ``--mesh_data``, the resident path runs
``--scan_steps`` chunks of graph replays over NCCL (the halos, gathers
and moments' all-reduces captured too) or of eager steps over gloo; the
coordinator evaluates with the replicated generator on the whole plane
while the others wait;
a checkpoint holds the pool in the JAX package's global layout (slots
over data, H over space, W over wspace), and the pix2pix nets' BN
states, equal on every rank.  ``--phase test`` of a spatial run's
checkpoint runs in one process on the whole plane.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.loader import (Dataset, DeviceDataset, _load_triplet,
                           train_iterator)
from ..data.preprocess import make_preprocess_train
from ..parallel import distributed, dp, mesh
from ..parallel.spatial_step import shard_batch
from ..utils import checkpoint as ckpt
from ..utils.cuda_graph import ForwardGraphs
from ..utils.profiling import StepTimer, TraceWindow
from ..utils.summary import SummaryWriter
from . import evaluate, fused
from .cycle import new_cycle_nets
from .step import (adam_init, build_step_fn, init_state, lr_schedule,
                   new_discriminator)


def _patch_discriminators(cfg, device):
    """A spatial run's discriminator(s), with the patch head, for a
    process that tests its checkpoint on the whole plane."""
    if cfg.loss_mode == "cycle":
        return new_cycle_nets(cfg, head="patch")[1].to(device)
    return new_discriminator(cfg, head="patch").to(device)


def _dataset_root(cfg: Config) -> str:
    if os.path.isdir(cfg.dataset_dir):
        return cfg.dataset_dir
    return os.path.join("./datasets", cfg.dataset_dir)


class Trainer:
    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg.validate()
        self.cycle = cfg.loss_mode == "cycle"
        # ---- one rank a card: data parallelism (trainer.py:49-77), or a
        # (data x space[ x wspace]) grid (trainer.py:79-105) ----
        run_cfg = cfg
        self.grid = None
        if mesh.is_spatial(cfg) and cfg.phase != "train":
            # a spatial run's checkpoint tested in one process, whole plane
            run_cfg = cfg.replace(mesh_data=1, mesh_space=1, mesh_space_w=1)
        elif mesh.is_spatial(cfg):
            self.grid = mesh.grid(cfg)
        self.group = self.grid.world if self.grid is not None \
            else dp.data_group(run_cfg)
        self.world = 1 if self.group is None else \
            distributed.world_size(self.group)
        self.rank = 0 if self.group is None else distributed.rank(self.group)
        self.is_coord = self.rank == 0
        # the batch's shards: the data rows (the effective batch divides
        # by them, Config.validate; the host iterator's check waits for
        # the path, in train)
        self.n_rows, self.row = ((self.grid.data, self.grid.d)
                                 if self.grid is not None
                                 else (self.world, self.rank))
        self.local_bs = cfg.batch_size // self.n_rows
        self.host_why = None  # why the split is not resident, once decided
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is visible")
        self.root = _dataset_root(cfg)
        self.state = init_state(
            run_cfg, torch.Generator().manual_seed(cfg.data_seed),
            self.device, self.group)
        if run_cfg is not cfg and not cfg.use_pix2pix:
            # the spatial run's patch-head D (the pix2pix D is one net)
            disc = _patch_discriminators(cfg, self.device)
            self.state = self.state._replace(disc_params=disc,
                                             d_opt=adam_init(disc))
        if self.group is not None:
            dp.broadcast_state(self.state, self.group)
        # the other ranks wait out the coordinator's eval here
        self.eval_wait = dp.wait_group(self.group)
        self.step_fn = build_step_fn(run_cfg, self.group)
        self.data_gen = torch.Generator(device=self.device).manual_seed(
            cfg.data_seed)
        self.pool_gen = torch.Generator().manual_seed(cfg.data_seed)
        # the step's learning rate, written each epoch (lr_schedule)
        self.lr = torch.zeros((), dtype=torch.float32, device=self.device)
        # the eval's and the service's forward graphs (evaluate.generate)
        self.fwd_graphs = ForwardGraphs()
        self.preprocess = make_preprocess_train(cfg)
        # host-side source shrink cap before upload (loader._downscale)
        self.max_src_hw = (
            (cfg.image_height * cfg.host_downscale,
             cfg.image_width * cfg.host_downscale)
            if cfg.host_downscale else None)
        # epoch-invariant ground-truth seg labels, pulled once per run
        self._eval_seg_cache: dict = {}
        self._ema_gen = None  # the generator that holds the EMA at eval
        self._ckpt_base = 0   # checkpoint number of epoch 0
        self._prof: Optional[TraceWindow] = None
        self._timer = StepTimer()

    def generate(self, images01, as_u8: bool = False) -> np.ndarray:
        """See evaluate.generate; runs the EMA shadow under --gen_ema."""
        return evaluate.generate(self.cfg, evaluate.eval_generator(self),
                                 images01, self.device, as_u8=as_u8,
                                 gen_bn=self.state.gen_bn,
                                 graphs=self.fwd_graphs)

    def _maybe_device_dataset(self):
        """The training split resident on the device (loader.DeviceDataset)
        when it fits cfg.device_dataset_mb, as the JAX trainer decides
        (trainer.py:152-197); under ``--loss_mode cycle`` the pair
        (trainA, trainB), both resident or neither, their sum against the
        budget.  None keeps the host iterator, for an empty budget, a split
        smaller than a batch, or splits that do not fit; ``host_why`` then
        says which.

        Under a world of several ranks each rank holds the whole split on
        its card (the JAX mesh's replica, trainer.py:178-182), the budget
        counted a card, and the ranks agree (``dp.agree``) before any
        step: where one rank cannot build it (sources of several shapes,
        a card that is full: ranks sharing a card meet it one at a time),
        every rank takes the host iterator."""
        dss, why = self._device_splits()
        if self.world > 1 and not dp.agree(dss is not None, self.group):
            if dss is not None:
                dss = None
                why = "another rank could not hold it"
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
        self.host_why = why
        if dss is None:
            return None
        on = f" on rank {self.rank}" if self.world > 1 else ""
        print(f" [*] training split{'s' if self.cycle else ''} resident on "
              f"device{on} ({sum(d.nbytes for d in dss) >> 20} MB, "
              f"{'+'.join(str(len(d)) for d in dss)} triplets)")
        return dss if self.cycle else dss[0]

    def _device_splits(self):
        """(the resident splits, None), or (None, why not)."""
        cfg = self.cfg
        if not cfg.device_dataset_mb:
            return None, "--device_dataset_mb 0"
        splits = ("trainA", "trainB") if self.cycle else ("trainA",)
        est = 0
        for split in splits:
            files = Dataset(self.root, split).files()
            n = min(len(files), int(cfg.train_size))
            if n < cfg.batch_size:
                return None, (f"{split} has {n} triplets, fewer than a "
                              f"batch of {cfg.batch_size}")
            probe = _load_triplet(files[0], split,
                                  cache_bytes=cfg.decode_cache_mb << 20,
                                  max_hw=self.max_src_hw)
            est += sum(a.nbytes for a in probe) * n
        if est > cfg.device_dataset_mb << 20:
            return None, (f"{est >> 20} MB a card, over --device_dataset_mb "
                          f"{cfg.device_dataset_mb}")
        try:
            return tuple(DeviceDataset(self.root, split,
                                       max_hw=self.max_src_hw,
                                       cache_mb=cfg.decode_cache_mb,
                                       train_size=cfg.train_size,
                                       device=self.device)
                         for split in splits), None
        except (ValueError, torch.cuda.OutOfMemoryError) as e:
            # sources of several shapes do not stack; the card may be full
            on = f" on rank {self.rank}" if self.world > 1 else ""
            print(f" [!] device dataset cache disabled{on}: "
                  f"{type(e).__name__}: {e}")
            return None, f"{type(e).__name__}{on}"

    def _save(self, epoch: int):
        ckpt.save(self.state, self.cfg.checkpoint_dir, self.cfg.dataset_dir,
                  self._ckpt_base + epoch, self.group, self.grid)

    def _upload(self, raw: dict) -> list:
        """A decoded batch's img, seg, cls and aug on the device (through
        pinned memory on the card, so the copies do not sync the host)."""
        pinned = self.device.type == "cuda"
        ts = [torch.from_numpy(raw[k]) for k in ("img", "seg", "cls", "aug")]
        if pinned:
            ts = [t.pin_memory() for t in ts]
        return [t.to(self.device, non_blocking=pinned) for t in ts]

    def _host_epoch(self, epoch: int, g_losses: list, d_losses: list,
                    global_step: int, start_time: float) -> int:
        """One epoch over the host iterator: decoded uint8 batches,
        uploaded, preprocessed on the device, one step each; under
        ``--loss_mode cycle`` trainA's iterator zipped with trainB's, whose
        shuffle seed is ``data_seed + 7919``.  Under ``--mesh_data`` this
        rank's ``local_bs`` rows of each global batch, preprocessed at
        their rows of the global batch (trainer.py:239-270)."""
        cfg = self.cfg
        domains = ((0, "trainA"), (fused.B_SEED_OFFSET, "trainB")) \
            if self.cycle else ((0, "trainA"),)
        size = cfg.train_size
        if self.cycle:
            # the zip ends with the shorter split; cut the longer one's
            # shuffled list there too (its first batches are unchanged),
            # so no producer thread is left blocked on a full queue
            size = min(size, *(len(Dataset(self.root, s).files())
                               for _, s in domains))
        its = [train_iterator(
            self.root, self.local_bs, cfg.data_seed + off,
            use_augmentation=cfg.use_augmentation, epoch=epoch,
            train_size=size, prefetch=cfg.prefetch, split=split,
            cache_mb=cfg.decode_cache_mb, max_src_hw=self.max_src_hw,
            process_index=self.row, process_count=self.n_rows)
            for off, split in domains]
        for idx, raws in enumerate(zip(*its)):
            up = [self._upload(raw) for raw in raws]
            draws, pdraws, masks = fused.step_draws(
                self, *(u[0].shape[1] for u in up))
            # the draws are the global batch's: each rank takes its rows
            kws = [dict(global_b=fused.effective_batch(cfg),
                        sample_rows=raw["rows"]) if self.world > 1 else {}
                   for raw in raws]
            batches = [self.preprocess(img, seg, cls, d, aug, **kw)
                       for (img, seg, cls, aug), d, kw in zip(
                           up, draws if self.cycle else (draws,), kws)]
            batch = fused.two_domain(*batches) if self.cycle \
                else batches[0]
            if self.grid is not None:  # this rank's block of the plane
                batch = shard_batch(batch, self.grid)
            self.state, m = self.step_fn(self.state, batch, self.lr,
                                         pdraws, masks)
            global_step = fused.end_step(
                self, epoch, idx, m, up[0][0].shape[0] * self.n_rows,
                g_losses, d_losses, global_step, start_time)
        return global_step

    def _path_line(self, resident: bool) -> str:
        """The coordinator's line on where a rank's rows come from and how
        its steps run: under ``--scan_steps`` on the resident split, one
        CUDA graph a step where ``fused.captures`` (NCCL), else chunks of
        eager steps, and why."""
        cfg = self.cfg
        b_eff = fused.effective_batch(cfg)
        unit, i = ("data row", "d") if self.grid is not None \
            else ("rank", "r")
        if not resident:
            copies = ", with their augmented copies," \
                if cfg.use_augmentation else ""
            return (f"{self.local_bs} of each batch of {cfg.batch_size} a "
                    f"{unit}{copies} from the host iterator (the split is "
                    f"not resident: {self.host_why}); eager steps (the host "
                    "iterator's steps are not captured)")
        n, k = b_eff // self.n_rows, cfg.scan_steps
        backend = dp.backend(self.group)
        if k == 1:
            steps = "eager steps"
        elif fused.captures(self.device, backend):
            steps = (f"--scan_steps {k}: one CUDA graph a step, its "
                     f"{backend.upper()} collectives captured, {k} replays "
                     "a chunk")
        else:
            steps = (f"--scan_steps {k}: chunks of {k} eager steps ("
                     + ("gloo's collectives cannot be captured)"
                        if backend == "gloo" else "no CUDA graph here)"))
        return (f"{unit} {i} takes rows [{n}{i}, {n}({i} + 1)) of each "
                f"batch of {b_eff} (the JAX mesh's blocks), from the split "
                f"resident on each rank's card; {steps}")

    def train(self) -> dict:
        cfg = self.cfg
        dev_ds = self._maybe_device_dataset()
        if dev_ds is None and cfg.batch_size % self.n_rows:
            # the host iterator's condition, the JAX multi-process
            # trainer's (trainer.py:70-75); the resident split needs only
            # the effective batch to divide (its mesh's, dp.py:56)
            raise ValueError(
                f"batch_size={cfg.batch_size} must divide by the "
                f"{self.n_rows} data rows on the host iterator (each "
                "decodes its slice of the batch's files); the training "
                f"split is not resident: {self.host_why}")
        logdir = os.path.join(
            cfg.log_dir,
            datetime.datetime.now().strftime("%Y%m%d-%H%M%S"), "train")
        writer = SummaryWriter(logdir) if self.is_coord else None
        start_time = time.time()

        if cfg.continue_train:
            loaded = ckpt.latest_epoch(cfg.checkpoint_dir, cfg.dataset_dir)
            restored = ckpt.load(self.state, cfg.checkpoint_dir,
                                 cfg.dataset_dir, loaded, self.group,
                                 grid=self.grid)
            if restored is not None:
                self.state = restored
                self._ckpt_base = loaded + 1
                if self.group is not None:
                    dp.broadcast_state(self.state, self.group)
                if self.is_coord:
                    print(" [*] Load SUCCESS (" + ckpt.source(
                        cfg.checkpoint_dir, cfg.dataset_dir, loaded) + ")")
            else:
                print(" [!] Load failed...")
        elif self.is_coord:
            print(" [*] New training STARTED")
        if self.grid is not None and self.is_coord:
            g = self.grid
            print(f" [*] spatially sharded over {self.world} ranks "
                  f"({torch.distributed.get_backend(self.group)}): data "
                  f"{g.data} x space {g.space} x wspace {g.wspace}, a block "
                  f"of {cfg.image_height // g.space} x "
                  f"{cfg.image_width // g.wspace} a rank, "
                  + self._path_line(dev_ds is not None))
        elif self.world > 1 and self.is_coord:
            print(f" [*] data parallel over {self.world} ranks "
                  f"({torch.distributed.get_backend(self.group)}): "
                  + self._path_line(dev_ds is not None))

        epoch = 0
        last = {}
        global_step = self.state.step
        images = 0
        self._prof = TraceWindow(cfg.profile_dir) if cfg.profile_dir \
            else None
        make_batch = (fused.make_batch_fn(cfg, fused.own_rows(self))
                      if dev_ds is not None else None)
        # K steps a chunk through one CUDA graph, captured at the first
        graph = (fused.StepGraph(self, dev_ds, make_batch)
                 if dev_ds is not None and cfg.scan_steps > 1 else None)
        try:
            for epoch in range(cfg.epoch):
                self.lr.fill_(float(np.float32(lr_schedule(cfg, epoch))))
                g_losses, d_losses = [], []
                self._timer.reset()
                self._timer.start()
                if graph is not None:
                    global_step = fused.run_epoch_chunked(
                        self, epoch, graph, g_losses, d_losses, global_step,
                        start_time)
                elif dev_ds is not None:
                    global_step = fused.run_epoch_fused(
                        self, epoch, dev_ds, make_batch, g_losses,
                        d_losses, global_step, start_time)
                else:
                    global_step = self._host_epoch(
                        epoch, g_losses, d_losses, global_step, start_time)

                # throughput before eval, synced on the last loss
                rate = self._timer.read(d_losses[-1]) if d_losses else None
                if rate is not None:
                    images += rate["images"]

                # --eval_freq N: every Nth epoch and always the last
                do_eval = (epoch % cfg.eval_freq == 0
                           or epoch == cfg.epoch - 1)
                fake_concat, score = (self.test_during_train(epoch, writer)
                                      if do_eval else (None, None))
                if do_eval:
                    dp.barrier(self.eval_wait)
                if fake_concat is not None:
                    writer.image(f"Segmentation Epoch {epoch}", fake_concat,
                                 step=epoch)
                g_mean = None
                if g_losses:
                    g_mean = torch.stack(g_losses).float().mean().item()
                    if writer is not None:
                        writer.scalar("Generator Loss", g_mean, epoch)
                        writer.scalar("Discriminator Loss", torch.stack(
                            d_losses).float().mean().item(), epoch)
                        writer.scalar("Images/sec", rate["images_per_sec"],
                                      epoch)
                last = {"epoch": epoch, "score": score, "gen_loss": g_mean}
        except KeyboardInterrupt:
            self._save(epoch)
            raise
        finally:
            if self._prof is not None:
                self._prof.close()
            self._save(epoch)
            if writer is not None:
                writer.close()
        wall = time.time() - start_time
        if self.is_coord:
            print(f" [*] Training finished: step {global_step}, {images} "
                  f"images in {wall:.2f} s ({images / wall:.2f} img/s with "
                  "eval, saves and set-up)")
        return last

    def test_during_train(self, epoch: int,
                          writer: Optional[SummaryWriter] = None):
        """Epoch-end eval (evaluate.py), parity with model.py:307-378."""
        return evaluate.test_during_train(self, epoch, writer)

    def test(self):
        """Inference CLI (evaluate.py), parity with model.py:535-567."""
        return evaluate.run_test(self)

    def sample_model(self, epoch: int, idx: int):
        """Sample dump (evaluate.py), parity with model.py:506-525."""
        return evaluate.sample_model(self, epoch, idx)
