"""The split resident on each rank of the port's multi-rank trainer on
the CPU: ``train/fused.py``'s per-rank batch assembly against the JAX
package's fused batch, then ``sggan_tpu_torch.main`` over two gloo ranks
(``tests/_torch_dp_worker.py resident``, started once for the module so
that it runs beside the JAX compiles).

Held:

* each rank's batch is its block of the JAX package's
  ``fused.make_batch_fn`` global batch, the rows ``[r B'/N, (r + 1)
  B'/N)`` that ``with_sharding_constraint(batch, P(data))`` gives device
  r, with the same indices and the same draws: on 1, 2, 3 and 6 ranks
  (a batch of 3 doubled to 6: the whole batch, blocks of plain rows, of
  augmented rows, and one of each), under ``--mesh_space`` the data row's block cut to the
  rank's block of the plane (data 2 x space 2, space 2 x wspace 2), and
  both domains of the cycle mode; images within ``test_torch_data``'s
  ``IMG_ATOL``, masks exactly;
* the p2p ResNet (no pool, no batch norm: the mean of two shards' means
  is the batch's) over two ranks on the resident split: its epoch loss
  equals the one-process resident epoch's and the two ranks'
  host-iterator epoch's at rel 1e-4, and the ranks' states are equal bit
  for bit;
* ``--scan_steps 2`` under two ranks (the ResNet sggan, a batch of 1
  doubled, a pool of 2 slots a rank that fills and swaps) equals
  ``--scan_steps 1`` bit for bit: every loss, the state, the pool's count
  and rows, the saved checkpoint; prints and saves on the chunk
  boundaries (``chip_smoke.chunk_prints``, the JAX chunk loop's saves);
* a rank that cannot build the split sends both ranks to the host
  iterator, which trains what ``--device_dataset_mb 0`` trains;
* ``--mesh_data 2 --batch_size 1`` with augmentation trains on the
  resident split, and is refused on the host iterator;
* the chunked run saves and resumes with ``--continue_train``, the pool
  in the JAX global layout."""

import os
import pickle
import re
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import start_ranks, wait_ranks, write_dataset  # noqa: E402
from chip_smoke import chunk_prints  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.data import augment as jaug  # noqa: E402
from sggan_tpu.train import fused as jfused  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.data import augment as taug  # noqa: E402
from sggan_tpu_torch.data import preprocess as tpre  # noqa: E402
from sggan_tpu_torch.parallel import mesh  # noqa: E402
from sggan_tpu_torch.train import fused  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_data import (FAST, IMG_ATOL, N_CLASS,  # noqa: E402
                             _photometric_draws)

SH, SW, OUT, B, N_SRC = 48, 64, (32, 32), 3, 5
B_EFF = 2 * B
KW = dict(image_height=OUT[0], image_width=OUT[1], segment_class=N_CLASS,
          batch_size=B, use_augmentation=True, use_photometric=True)


@pytest.fixture(scope="module", autouse=True)
def job(tmp_path_factory):
    """8 train and 2 test triplets of 64x64 PNGs; the two ranks' runs,
    started here and waited for by the first test that reads them."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    write_dataset(root, 8, 2)
    work = tmp_path_factory.mktemp("dp_resident")
    out = {"root": root, "work": work,
           "procs": start_ranks("resident", [root, work])}
    yield out
    for p in out["procs"]:
        if p.poll() is None:
            p.kill()
        p.communicate()


def _outs(job) -> list:
    if "outs" not in job:
        job["outs"] = wait_ranks(job["procs"], 600)
        for r, (rc, out) in enumerate(job["outs"]):
            assert rc == 0, f"rank {r} failed:\n{out}"
    return [out for _, out in job["outs"]]


def _section(out: str, run: str) -> str:
    """A rank's output of one run (after its ``== <run>`` line)."""
    return out.split(f"== {run}\n", 1)[1].split("\n== ", 1)[0]


def _line(out: str, run: str) -> dict:
    m = re.search(rf"OK {run} rank \d step (\d+) gen_loss (\S+) digest "
                  rf"(\w+)", out)
    assert m, out
    return {"step": int(m[1]), "gen_loss": float(m[2]), "digest": m[3]}


def _rec(job, run: str, rank: int) -> dict:
    with open(job["work"] / f"{run}{rank}.pkl", "rb") as f:
        return pickle.load(f)


# ------------------------------------------------ the batch against JAX

def _jax_draws(key):
    """The draws the JAX ``preprocess_train`` takes from ``key`` for
    B_EFF rows (preprocess.py:111-160): each row's square-frame affine
    and photometric draws, then the final flips."""
    k_aug, k_flip = jax.random.split(key)

    def one(k):
        k_geo, k_pho = jax.random.split(k)
        p = jaug.random_affine_params(k_geo, SH, SH)
        return p.matrix, p.flip, _photometric_draws(k_pho, OUT)

    m, f, pho = jax.vmap(one)(jax.random.split(k_aug, B_EFF))
    return m, f, pho, jax.random.bernoulli(k_flip, 0.5, (B_EFF,))


def _port_draws(out) -> tpre.PreprocessDraws:
    m, f, pho, flip = (jax.tree.map(lambda a: torch.from_numpy(
        np.array(a)), x) for x in out)
    return tpre.PreprocessDraws(taug.AffineParams(m, f),
                                taug.PhotometricDraws(**pho), flip)


def _split(seed: int):
    r = np.random.default_rng(seed)
    return (r.integers(0, 255, (N_SRC, SH, SW, 3), np.uint8),
            r.integers(0, 255, (N_SRC, SH, SW, 3), np.uint8),
            r.integers(0, N_CLASS + 2, (N_SRC, SH, SW), np.uint8))


@pytest.fixture(scope="module")
def global_batches():
    """Two resident splits, a step's indices into each, the JAX global
    batch of each (the cycle step's keys: ``split(k_pre)``), and the
    port's draws of each key."""
    key = jax.random.PRNGKey(3)
    k_a, k_b = jax.random.split(key)
    draws = jax.jit(_jax_draws).lower(key).compile(FAST)
    splits = [_split(11), _split(12)]
    idxs = [np.array([4, 0, 2], np.int32), np.array([1, 3, 3], np.int32)]
    make = jax.jit(jfused.make_batch_fn(JConfig(**KW))).lower(
        *splits[0], idxs[0], key).compile(FAST)
    out = {}
    for name, k, s, ix in (("plain", key, 0, 0), ("a", k_a, 0, 0),
                           ("b", k_b, 1, 1)):
        out[name] = (jax.tree.map(np.asarray, make(*splits[s], idxs[ix], k)),
                     _port_draws(draws(k)))
    return splits, idxs, out


def _check(got: dict, ref: dict, lo: int, hi: int, grid=None) -> None:
    """``got`` is rows [lo, hi) of the global batch ``ref``, under ``grid``
    cut to the rank's block of the plane (each tensor by its own size:
    the image's rows, the mask grid's)."""
    S, W, s, w = (1, 1, 0, 0) if grid is None else (
        grid.space, grid.wspace, grid.s, grid.w)
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        h, ww = v.shape[1] // S, v.shape[2] // W
        want = v[lo:hi, s * h:(s + 1) * h, w * ww:(w + 1) * ww]
        if k.startswith("mask"):
            np.testing.assert_array_equal(got[k].numpy(), want, err_msg=k)
        else:
            assert got[k].shape == want.shape, k
            assert np.abs(got[k].numpy() - want).max() <= IMG_ATOL, k


def _grid(data, space, wspace, rank):
    no = mesh.Axis(None, None, None)
    return mesh.Grid(data, space, wspace, rank,
                     *mesh.coords(rank, space, wspace), None, None, no, no,
                     None)


@pytest.mark.parametrize("layout", ["dp", "sp", "cycle"])
def test_rank_blocks_are_the_jax_global_batch(global_batches, layout):
    splits, idxs, refs = global_batches
    cfg = Config(**KW)
    ds = [types.SimpleNamespace(img=torch.from_numpy(i),
                                seg=torch.from_numpy(s),
                                cls=torch.from_numpy(c)) for i, s, c in splits]
    ix = [torch.from_numpy(i.astype(np.int64)) for i in idxs]
    if layout == "cycle":
        (ra, da), (rb, db) = refs["a"], refs["b"]
        ref = dict(ra, real_b=rb["real_a"], seg_b=rb["seg_a"],
                   mask_b=rb["mask_a"])
        for r in range(2):
            lo, hi = mesh.block(B_EFF, 2, r)
            tr = types.SimpleNamespace(cycle=True, grid=None)
            got = fused.assemble(tr, ds, fused.make_batch_fn(cfg, (lo, hi)),
                                 ix, (da, db))
            _check(got, ref, lo, hi)
        return
    ref, draws = refs["plain"]
    jobs = ([(None, mesh.block(B_EFF, n, r)) for n in (1, 2, 3, 6)
             for r in range(n)] if layout == "dp" else
            [(g, g.own_rows(B_EFF)) for d, s, w in ((2, 2, 1), (1, 2, 2))
             for g in (_grid(d, s, w, r) for r in range(d * s * w))])
    for grid, (lo, hi) in jobs:
        tr = types.SimpleNamespace(cycle=False, grid=grid)
        got = fused.assemble(tr, ds[:1], fused.make_batch_fn(cfg, (lo, hi)),
                             ix[:1], draws)
        _check(got, ref, lo, hi, grid)


# --------------------------------------------------- the two-rank runs

def test_two_rank_resident_epoch_equals_one_process(job, tmp_path):
    outs = _outs(job)
    cfg = Config(dataset_dir=str(job["root"]), image_height=32,
                 image_width=32, ngf=4, ndf=4, segment_class=8,
                 batch_size=4, compute_dtype="float32", use_resnet=True,
                 loss_mode="p2p", epoch=1, print_freq=1,
                 **{f"{d}_dir": str(tmp_path / d)
                    for d in ("checkpoint", "sample", "test", "log")})
    one = Trainer(cfg, device="cpu")
    ref = one.train()["gen_loss"]
    assert one.host_why is None and one.state.step == 2
    for run in ("p2p", "p2p_host"):
        a, b = (_line(o, run) for o in outs)
        assert a == b, run
        assert a["step"] == 2
        assert a["gen_loss"] == pytest.approx(ref, rel=1e-4), run
    res = [_section(o, "p2p") for o in outs]
    for r in range(2):
        assert f" [*] training split resident on device on rank {r} " \
            "(0 MB, 8 triplets)" in res[r]
    assert " [*] data parallel over 2 ranks (gloo): rank r takes rows " \
        "[4r, 4(r + 1)) of each batch of 8 (the JAX mesh's blocks), from " \
        "the split resident on each rank's card; --scan_steps 8: chunks " \
        "of 8 eager steps (gloo's collectives cannot be captured)" in res[0]
    host = _section(outs[0], "p2p_host")
    assert "from the host iterator (the split is not resident: " \
        "--device_dataset_mb 0)" in host and "resident on" not in host


def test_chunks_equal_single_steps_under_two_ranks(job):
    """The ResNet sggan at a batch of 1 doubled, 4 steps, print_freq 2,
    save_freq 3: chunks of 2 against single steps."""
    outs = _outs(job)
    for r in range(2):
        k2, k1 = _rec(job, "scan2", r), _rec(job, "scan1", r)
        assert len(k2["losses"]) == 4 and k2["losses"] == k1["losses"]
        assert (k2["step"], k2["count"]) == (k1["step"], k1["count"]) \
            == (4, 2)
        for k, v in k1["pool"].items():
            np.testing.assert_array_equal(k2["pool"][k], v, err_msg=k)
        # the JAX chunk loop saves where a chunk crosses a multiple of
        # save_freq; train() saves again at its end
        assert k2["saves"] == [4, 4] and k1["saves"] == [3, 4]
    for run in ("scan2", "scan1"):
        a, b = (_line(o, run) for o in outs)
        assert a == b
    assert _line(outs[0], "scan2") == _line(outs[0], "scan1")
    for run, k in (("scan2", 2), ("scan1", 1)):
        printed = [int(m) for m in re.findall(
            r"Epoch: \[ 0\] \[\s*(\d+)\]", _section(outs[0], run))]
        assert printed == chunk_prints(4, k, 2), run
        assert "Epoch:" not in _section(outs[1], run)
    cps = [torch.load(job["work"] / run / "ckpt" / "city" / "train" /
                      "cp-0000.pt", weights_only=True)
           for run in ("scan2", "scan1")]

    def flat(x, pre=""):
        if isinstance(x, dict):
            return {k2: v for k, v in x.items()
                    for k2, v in flat(v, f"{pre}{k}.").items()}
        return {pre: x}
    a, b = flat(cps[0]), flat(cps[1])
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_a_rank_that_cannot_hold_the_split_sends_every_rank_to_the_host(
        job):
    outs = _outs(job)
    sec = [_section(o, "disagree") for o in outs]
    assert " [!] device dataset cache disabled on rank 1: ValueError: " \
        "sources of several shapes" in sec[1]
    assert "from the host iterator (the split is not resident: another " \
        "rank could not hold it)" in sec[0]
    assert not any("resident on device" in s for s in sec)
    a, b = (_line(o, "disagree") for o in outs)
    assert a == b == _line(outs[0], "p2p_host")


def test_batch_of_one_trains_resident_and_is_refused_on_the_host(job):
    outs = _outs(job)
    for r, out in enumerate(outs):
        assert f" [*] training split resident on device on rank {r} " \
            "(0 MB, 4 triplets)" in _section(out, "scan1")
        assert _line(out, "scan1")["step"] == 4
        assert f"OK refused rank {r}: batch_size=1 must divide by the 2 " \
            "data rows on the host iterator (each decodes its slice of " \
            "the batch's files); the training split is not resident: " \
            "--device_dataset_mb 0" in _section(out, "b1_host")
    assert "rank r takes rows [1r, 1(r + 1)) of each batch of 2" \
        in _section(outs[0], "scan1")


def test_resident_run_saves_and_resumes(job):
    outs = _outs(job)
    sec = [_section(o, "resume") for o in outs]
    assert " [*] Load SUCCESS (cp-0000.pt)" in sec[0]
    assert "chunks of 2 eager steps" in sec[0]
    a, b = (_line(o, "resume") for o in outs)
    assert a == b and a["step"] == 8
    saved = torch.load(job["work"] / "scan2" / "ckpt" / "city" / "train" /
                       "cp-0001.pt", weights_only=True)
    assert saved["step"] == 8 and saved["pool_count"] == 2
    for r in range(2):
        rec = _rec(job, "resume", r)
        assert (rec["step"], rec["count"]) == (8, 2)
        for k, v in rec["pool"].items():
            np.testing.assert_array_equal(
                saved["pool_buffer"][k][2 * r:2 * (r + 1)].numpy(), v,
                err_msg=k)


def test_ranks_import_no_jax(job):
    for out in _outs(job):
        assert "OK imported no JAX module: True" in out, out
