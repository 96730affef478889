"""The port's data-parallel trainer on the CPU: ``sggan_tpu_torch.main``
with ``--mesh_data 2`` in two gloo ranks (``tests/_torch_dp_worker.py
trainer``, launched once for the module), as ``tests/test_distributed.py:
70-160`` runs the JAX trainer over two processes.  The p2p ResNet at
32x32, ngf and ndf 4, a global batch of 4 doubled by augmentation (2
files a rank), one epoch of 2 steps over 8 triplets, then a resume, on
the host iterator (``--device_dataset_mb 0``; the split resident on each
rank is ``tests/test_torch_dp_resident.py``'s).

Held: the epoch's generator loss equals the one-process trainer's over
the same global batches (rel 1e-4: the mean of two shards' means is the
batch's mean), and both ranks end with the same loss and state bit for
bit; only the coordinator prints, evaluates and writes TensorBoard; the
checkpoint holds both ranks' pool rows; ``--continue_train`` resumes at
the saved step.  Each rank's rows of a global batch, preprocessed with
the draws of the whole batch, are the one-process preprocess of that
batch; the global-row preprocess equals the JAX package's
``preprocess_train(..., global_b, sample_rows)`` with the same draws.  A
world size other than ``--mesh_data``, the pix2pix nets' spatial step,
``--mesh_data 2`` outside a launcher and a ``LOCAL_RANK`` with no card behind it each
raise."""

import os
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import run_ranks, write_dataset  # noqa: E402
from sggan_tpu.data import preprocess as jpre  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.data import preprocess as tpre  # noqa: E402
from sggan_tpu_torch.parallel import distributed  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from sggan_tpu_torch.utils.summary import read_scalars  # noqa: E402
from test_torch_data import (FAST, MASK, N_CLASS, OUT, case,  # noqa: E402,F401
                             IMG_ATOL)

N_TRAIN, N_TEST = 8, 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """8 train and 2 test triplets of 64x64 PNGs; the two ranks' run."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    write_dataset(root, N_TRAIN, N_TEST)
    work = tmp_path_factory.mktemp("dp_trainer")
    outs = run_ranks("trainer", [root, work])
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    return str(root), work, [out for _, out in outs]


def _line(out: str, what: str) -> dict:
    line = next(x for x in out.splitlines() if x.startswith(f"OK {what} "))
    words = line.split()
    return {words[i]: words[i + 1] for i in range(2, len(words) - 1, 2)}


def test_epoch_loss_equals_the_one_process_trainer(job, tmp_path):
    root, _, outs = job
    got = float(_line(outs[0], "trainer")["gen_loss"])
    cfg = Config(dataset_dir=root, image_height=32, image_width=32, ngf=4,
                 ndf=4, segment_class=8, batch_size=4,
                 compute_dtype="float32", use_resnet=True, loss_mode="p2p",
                 epoch=1, print_freq=1,
                 **{f"{d}_dir": str(tmp_path / d)
                    for d in ("checkpoint", "sample", "test", "log")})
    tr = Trainer(cfg.replace(device_dataset_mb=0), device="cpu")
    assert tr.world == 1 and tr.local_bs == 4
    ref = tr.train()["gen_loss"]
    assert got == pytest.approx(ref, rel=1e-4)
    assert tr.state.step == int(_line(outs[0], "trainer")["step"]) == 2


def test_ranks_end_with_the_same_loss_and_state_bitwise(job):
    for what in ("trainer", "resume"):
        a, b = (_line(out, what) for out in job[2])
        assert a["gen_loss"] == b["gen_loss"] and a["digest"] == b["digest"]
        assert a["rank"] == "0" and b["rank"] == "1"


def test_only_the_coordinator_prints_evaluates_and_writes(job):
    _, work, outs = job
    assert "Epoch: [ 0]" in outs[0] and "Epoch:" not in outs[1]
    assert " [*] data parallel over 2 ranks (gloo)" in outs[0]
    assert "eager steps (the host iterator's steps are not captured)" \
        in outs[0]
    assert "New training STARTED" not in outs[1]
    assert sorted(os.listdir(work / "test0")) == [f"v{i}.png"
                                                  for i in range(N_TEST)]
    scalars = {}
    for d, _, files in os.walk(work / "logs0"):
        for f in files:
            scalars.update(read_scalars(os.path.join(d, f)))
    assert {"Generator Loss", "Mean IoU"} <= scalars.keys()
    for d in ("test1", "logs1", "sample1"):
        assert not (work / d).exists(), d


def test_resume_continues_at_the_saved_step(job):
    _, work, outs = job
    assert outs[0].count(" [*] Load SUCCESS") == 1
    assert "Load SUCCESS" not in outs[1]
    assert _line(outs[0], "resume")["step"] == "4"
    ck = work / "ckpt" / "city" / "train"
    assert torch.load(ck / "cp-0001.pt", weights_only=True)["step"] == 4
    assert "OK group still joined True" in outs[0]


def test_checkpoint_holds_both_ranks_pool_rows(job):
    """The p2p pool's one slot a rank, gathered into the JAX global layout
    of 2 rows; one process loads the checkpoint only where it does not
    train (``pool=False``, as the test phase and the service load it)."""
    root, work, _ = job
    tr = torch.load(work / "ckpt" / "city" / "train" / "cp-0000.pt",
                    weights_only=True)
    assert tr["pool_buffer"]["fake"].shape == (2, 32, 32, 3)
    assert tr["pool_count"] == 0
    cfg = Config(dataset_dir=root, image_height=32, image_width=32, ngf=4,
                 ndf=4, segment_class=8, batch_size=4, use_resnet=True,
                 loss_mode="p2p", compute_dtype="float32",
                 checkpoint_dir=str(work / "ckpt"))
    one = Trainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="a pool of 2 rows, 2 ranks of 1 "
                                         "slots; this run has 1 ranks"):
        ckpt.load(one.state, cfg.checkpoint_dir, cfg.dataset_dir, 0)
    loaded = ckpt.load(one.state, cfg.checkpoint_dir, cfg.dataset_dir, 0,
                       pool=False)
    assert loaded.step == 2 and loaded.pool is one.state.pool


def test_each_ranks_rows_preprocess_as_the_global_batch(job):
    """Each rank's half of the first global batch (its two files' plain
    and augmented rows, at their rows of the global batch) equals the
    one-process preprocess of the whole batch with the same draws, at
    those rows, bit for bit."""
    root, work, _ = job
    from sggan_tpu_torch.data.loader import train_iterator
    cfg = Config(dataset_dir=root, image_height=32, image_width=32,
                 segment_class=8, batch_size=4)
    raw = next(iter(train_iterator(root, 4, cfg.data_seed, epoch=0)))
    draws = tpre.draw_preprocess(torch.Generator().manual_seed(5), 8,
                                 raw["img"].shape[1], cfg.image_size)
    ref = tpre.make_preprocess_train(cfg)(
        *(torch.from_numpy(raw[k]) for k in ("img", "seg", "cls")), draws,
        torch.from_numpy(raw["aug"]))
    for r in range(2):
        with open(work / f"pre{r}.pkl", "rb") as f:
            got = pickle.load(f)
        np.testing.assert_array_equal(got["rows"], [2 * r, 2 * r + 1,
                                                    4 + 2 * r, 5 + 2 * r])
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v.numpy()[got["rows"]],
                                          err_msg=k)


@pytest.mark.parametrize("layout", ["half", "dynamic"])
def test_global_rows_match_jax(case, layout):
    """A process's rows of a global batch of 4: its plain and augmented
    copies of one file (rows 1 and 3 under "half"), preprocessed with the
    key's draws for the whole batch, as ``sggan_tpu``'s
    ``preprocess_train(..., global_b=4, sample_rows=rows)``."""
    img, seg, cls, key, draws, _ = case
    rows = np.array([1, 3], np.int32)
    flags = np.array([False, True])
    sel = [1, 1] if layout == "half" else [1, 3]
    kw = dict(out_hw=OUT, mask_hw=MASK, n_class=N_CLASS,
              photometric=True, aug_layout=layout, global_b=4)
    args = (img[sel], seg[sel], cls[sel])
    ref = jax.tree.map(np.asarray, jpre.preprocess_train.lower(
        *args, key, flags, sample_rows=rows, **kw).compile(FAST)(
        *args, key, flags, sample_rows=rows))
    got = tpre.preprocess_train(*map(torch.from_numpy, args), draws,
                                torch.from_numpy(flags), sample_rows=rows,
                                **kw)
    np.testing.assert_array_equal(got["mask_a"].numpy(), ref["mask_a"])
    for k in ("real_a", "seg_a"):
        assert np.abs(got[k].numpy() - ref[k]).max() <= IMG_ATOL, k


def test_group_mismatches_are_refused(job, monkeypatch):
    """In the 2-rank job: ``--mesh_data`` 4 or 1 names both numbers,
    ``--mesh_data 2 --mesh_space 2`` the 4 ranks it needs, a data row's
    spatial ranks on two hosts get the JAX trainer's own refusal
    (trainer.py:55-66), the pix2pix nets' spatial trainer builds (the
    pix2pix discriminator, a block of 16 x 32), and the ``data`` mesh
    spans both ranks.  In one process: ``--mesh_data 2`` with no
    launcher's environment, and a ``LOCAL_RANK`` with no card behind
    it."""
    for r, out in enumerate(job[2]):
        assert "OK refused [('mesh_data', 4)]: --mesh_data 4 must equal " \
            "the world size, 2" in out
        assert "OK refused [('mesh_data', 1)]: --mesh_data 1 must equal " \
            "the world size, 2" in out
        assert "OK refused [('mesh_data', 2), ('mesh_space', 2)]: " \
            "--mesh_data 2 x --mesh_space 2 x --mesh_space_w 1 = 4 ranks " \
            "must equal the world size, 2" in out
        assert "OK built [('loss_mode', 'p2p'), ('mesh_data', 1), " \
            "('mesh_space', 2), ('use_pix2pix', True)]: " \
            "DiscriminatorPix2pix, space 2, a block of (16, 32)" in out
        assert "OK refused [('mesh_data', 1), ('mesh_space', 2)]: " \
            "multi-host spatial sharding needs the space grid (2) to " \
            "divide the local device count (1) so every host owns whole " \
            "data rows of the mesh" in out
        assert f"OK mesh ('data',) 2 coordinator {r == 0}" in out
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK is not set"):
        tmain.main(["--mesh_data", "2"], device="cpu")
    assert not torch.distributed.is_initialized()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("LOCAL_RANK", str(n))
    with pytest.raises(RuntimeError, match=f"LOCAL_RANK={n} has no CUDA "
                                           f"device behind it: {n} visible"):
        distributed.device("cuda")


def test_ranks_import_no_jax(job):
    for out in job[2]:
        assert "OK imported no JAX module: True" in out, out
