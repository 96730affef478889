"""The port's spatial trainer on the CPU: ``sggan_tpu_torch.main`` with
``--mesh_space 2`` in two gloo ranks (``tests/_torch_sp_worker.py
trainer``, launched once for the module), as the JAX trainer trains on a
(data x space) mesh (``sggan_tpu/train/trainer.py:79-105``).  The ResNet
sggan at 32x32, ngf and ndf 4, pool 4, a batch of 2 doubled by
augmentation, one epoch of 4 steps over 8 triplets of
``write_dataset``'s PNGs on the split resident on each rank (the CLI's
default), then a resume.

Held: both ranks end each run with the same losses and the same state
bit for bit (the pool blocks their own); only the coordinator prints,
evaluates on the whole plane and writes TensorBoard; the checkpoint's
pool has the JAX package's global layout (the shapes of its
``init_sp_state``, by ``jax.eval_shape``) and holds each rank's block at
its rows; ``--continue_train`` resumes at the saved step with each rank's
block back; ``--phase test`` of the spatial checkpoint in one process
loads it (the patch-head discriminator) and writes the fakes;
``--compat_fake_history`` with ``--mesh_space 2`` is refused."""

import os
import pickle
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import run_ranks, write_dataset  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel.spatial_step import init_sp_state  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.utils.summary import read_scalars  # noqa: E402

N_TRAIN, N_TEST, MAX_SIZE = 8, 2, 4


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets") / "city"
    write_dataset(root, N_TRAIN, N_TEST)
    work = tmp_path_factory.mktemp("sp_trainer")
    outs = run_ranks("trainer", [root, work], worker="_torch_sp_worker.py")
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
    return root, work, [out for _, out in outs]


def _line(out: str, what: str) -> dict:
    m = re.search(rf"OK {what} rank \d step (\d+) count (\d+) gen_loss "
                  rf"(\S+) digest (\w+)", out)
    assert m, out
    return {"step": int(m[1]), "count": int(m[2]), "loss": float(m[3]),
            "digest": m[4]}


def _pools(work, what: str) -> list:
    out = []
    for r in range(2):
        with open(os.path.join(work, f"{what}{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_ranks_end_with_the_same_losses_and_state(job):
    _, _, outs = job
    for what in ("trainer", "resume"):
        a, b = (_line(o, what) for o in outs)
        assert a == b, what
        assert np.isfinite(a["loss"])
    assert _line(outs[0], "trainer")["step"] == 4


def test_only_the_coordinator_prints_evaluates_and_writes(job):
    _, work, outs = job
    assert " [*] spatially sharded over 2 ranks (gloo): data 1 x space 2 " \
        "x wspace 1, a block of 16 x 32 a rank, data row d takes rows " \
        "[4d, 4(d + 1)) of each batch of 4 (the JAX mesh's blocks), from " \
        "the split resident on each rank's card; --scan_steps 8: chunks " \
        "of 8 eager steps" in outs[0]
    for r in range(2):
        assert f" [*] training split resident on device on rank {r}" \
            in outs[r]
    assert "Epoch: [ 0]" in outs[0] and "Epoch:" not in outs[1]
    assert sorted(os.listdir(work / "test0")) == ["v0.png", "v1.png"]
    assert not (work / "test1").exists() or not os.listdir(work / "test1")
    logs = [os.path.join(dp, f) for dp, _, fs in os.walk(work / "logs0")
            for f in fs if f.startswith("events.out.tfevents")]
    assert logs and "Generator Loss" in read_scalars(logs[0])
    assert not (work / "logs1").exists()


def test_checkpoint_pool_has_the_jax_global_layout(job):
    """The saved pool has the shapes of the JAX package's
    ``init_sp_state(n_data=1)`` and holds rank r's block at rows [16 r,
    16 (r + 1)) (the fakes) and [2 r, 2 (r + 1)) (the masks)."""
    _, work, _ = job
    jcfg = JConfig(image_height=32, image_width=32, ngf=4, ndf=4,
                   segment_class=8, max_size=MAX_SIZE, use_resnet=True,
                   loss_mode="sggan", mesh_space=2)
    want = jax.eval_shape(lambda k: init_sp_state(jcfg, k, n_data=1),
                          jax.random.PRNGKey(0)).pool.buffer
    saved = torch.load(work / "ckpt" / "city" / "train" / "cp-0000.pt",
                       weights_only=True)
    assert saved["step"] == 4 and saved["pool_count"] == MAX_SIZE
    blocks = _pools(work, "trainer")
    for k, v in want.items():
        got = saved["pool_buffer"][k]
        assert tuple(got.shape) == v.shape, k
        h = got.shape[1] // 2
        for r in range(2):
            np.testing.assert_array_equal(got[:, r * h:(r + 1) * h].numpy(),
                                          blocks[r][k])


def test_resume_continues_at_the_saved_step_with_each_block(job):
    _, work, outs = job
    assert " [*] Load SUCCESS" in outs[0]
    assert _line(outs[0], "resume")["step"] == 8
    saved = torch.load(work / "ckpt" / "city" / "train" / "cp-0001.pt",
                       weights_only=True)
    assert saved["step"] == 8
    blocks = _pools(work, "resume")
    for k, got in saved["pool_buffer"].items():
        h = got.shape[1] // 2
        for r in range(2):
            np.testing.assert_array_equal(got[:, r * h:(r + 1) * h].numpy(),
                                          blocks[r][k])


def test_phase_test_of_the_spatial_checkpoint_in_one_process(job, tmp_path,
                                                             monkeypatch):
    root, work, _ = job
    monkeypatch.chdir(tmp_path)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    tmain.main(["--phase", "test", "--dataset_dir", str(root),
                "--img_height", "32", "--img_width", "32", "--ngf", "4",
                "--ndf", "4", "--segment_class", "8", "--compute_dtype",
                "float32", "--use_resnet", "--loss_mode", "sggan",
                "--mesh_space", "2", "--checkpoint_dir",
                str(work / "ckpt"), "--test_dir", str(tmp_path / "out")],
               device="cpu")
    assert {"v0.png", "v1.png"} <= set(os.listdir(tmp_path / "out"))
    assert not torch.distributed.is_initialized()


def test_compat_fake_history_with_spatial_sharding_is_refused():
    with pytest.raises(ValueError, match="compat_fake_history"):
        Config(loss_mode="p2p", compat_fake_history=True,
               mesh_space=2).validate()


def test_ranks_import_no_jax(job):
    for out in job[2]:
        assert "OK imported no JAX module: True" in out, out
