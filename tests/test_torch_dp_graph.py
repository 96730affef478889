"""The multi-rank step as the port captures it on the card, held on the
CPU: ``train/fused.py``'s capture decision and the trainer's line that
says it, then two gloo ranks (``tests/_torch_dp_worker.py graph``,
started once for the module) running the chunk loop's step, eager here,
in every loss mode of the data-parallel step and in the spatial steps.

A CUDA graph replays what its capture recorded: every rank must make the
same collectives in the same order at every step (or the replays' NCCL
calls part), and nothing inside the step may read a tensor's value on
the host (a capture refuses the sync).  Held, over a chunk of 3 steps at
32x64 in f32:

* each step makes the collectives of the first (kind, group, peer,
  shape, dtype, in order), the ranks the same ones, each halo batch's
  sends received by their peers; the data-parallel steps two
  all-reduces, one bucket a net;
* the step runs where ``Tensor.item``, ``__bool__``, ``__float__``,
  ``__int__``, ``tolist`` and ``numpy`` raise, and no ``broadcast`` or
  ``barrier`` is made in it;
* the halo exchange and the gathers take the device-tensor code that NCCL
  runs (``dist.batch_isend_irecv``; ``spatial._via_host`` false), gloo
  moving the CPU's tensors;
* the collectives' counters recorded for one step (``StepGraph``'s
  ``comm_calls``, recorded at a capture on the card) are a third of their
  deltas over the chunk."""

import pickle
import types

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import start_ranks, wait_ranks, one_rank_group  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.parallel import dp, spatial  # noqa: E402
from sggan_tpu_torch.train import fused  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402

K = 3  # the chunk's steps
SMALL = dict(image_height=32, image_width=64, ngf=4, ndf=4, segment_class=8,
             batch_size=2, max_size=2, compute_dtype="float32",
             scan_steps=K, save_freq=0, print_freq=1000)
CASES = {
    "dp_sggan_resnet": dict(loss_mode="sggan", use_resnet=True,
                            gen_ema=0.999, mesh_data=2),
    "dp_p2p_unet": dict(loss_mode="p2p", dropout_mode="intended",
                        mesh_data=2),
    "dp_pix2pix": dict(loss_mode="p2p", use_pix2pix=True,
                       dropout_mode="intended", mesh_data=2),
    "dp_cycle_resnet": dict(loss_mode="cycle", use_resnet=True,
                            identity_lambda=5.0, Lg_lambda=5.0, mesh_data=2),
    "sp_sggan_resnet": dict(loss_mode="sggan", use_resnet=True,
                            mesh_space=2),
    "sp_pix2pix": dict(loss_mode="p2p", use_pix2pix=True,
                       dropout_mode="intended", mesh_space=2),
}


@pytest.fixture(scope="module", autouse=True)
def job(tmp_path_factory):
    """The two ranks' runs of every case, started with the module and
    waited for by the first test that reads them."""
    work = tmp_path_factory.mktemp("dp_graph")
    cases = work / "cases.pkl"
    with open(cases, "wb") as f:
        pickle.dump({k: {**SMALL, **v} for k, v in CASES.items()}, f)
    procs = start_ranks("graph", [cases, work])
    out = {}

    def result():
        if not out:
            out["outs"] = wait_ranks(procs, timeout=300)
            for rc, text in out["outs"]:
                assert rc == 0, text[-4000:]
            out["ranks"] = []
            for r in range(2):
                with open(work / f"rank{r}.pkl", "rb") as f:
                    out["ranks"].append(pickle.load(f))
        return out
    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.communicate()


def test_capture_decision():
    """Captured on a CUDA device with no group or an NCCL group; eager
    over gloo and on the CPU; a card's tensors take gloo's host detour,
    the CPU's the device-tensor code."""
    assert fused.captures(torch.device("cuda"), "nccl")
    assert fused.captures(torch.device("cuda", 1), None)
    assert not fused.captures("cuda", "gloo")
    assert not fused.captures("cpu", None)
    assert not fused.captures("cpu", "gloo")
    assert dp.backend(None) is None
    with one_rank_group() as g:
        assert dp.backend(g) == "gloo"
        assert not spatial._via_host(g, torch.zeros(1))
        card = types.SimpleNamespace(device=torch.device("cuda"))
        assert spatial._via_host(g, card)


def test_path_line_says_how_the_steps_run(monkeypatch):
    """The coordinator's line: one CUDA graph a step with its NCCL
    collectives, or eager steps and why."""
    monkeypatch.setattr(dp, "backend", lambda group: group)
    cfg = Config(**SMALL).replace(mesh_data=2, scan_steps=8)
    tr = types.SimpleNamespace(cfg=cfg, grid=None, n_rows=2, local_bs=1,
                               host_why="--device_dataset_mb 0")

    def line(device, group, resident=True, **kw):
        tr.device, tr.group = torch.device(device), group
        tr.cfg = cfg.replace(**kw)
        return Trainer._path_line(tr, resident)
    head = ("rank r takes rows [2r, 2(r + 1)) of each batch of 4 (the JAX "
            "mesh's blocks), from the split resident on each rank's card; ")
    assert line("cuda", "nccl") == head + (
        "--scan_steps 8: one CUDA graph a step, its NCCL collectives "
        "captured, 8 replays a chunk")
    assert line("cuda", "gloo") == line("cpu", "gloo") == head + (
        "--scan_steps 8: chunks of 8 eager steps (gloo's collectives "
        "cannot be captured)")
    assert line("cuda", "nccl", scan_steps=1) == head + "eager steps"
    assert line("cuda", "nccl", resident=False).endswith(
        "(the split is not resident: --device_dataset_mb 0); eager steps "
        "(the host iterator's steps are not captured)")


def _paired(logs: list) -> bool:
    """Whether the ranks' logs of one step make the same collectives in
    one order, and each ``batch_isend_irecv`` of theirs receives what the
    others send (rank, peer, shape, dtype)."""
    kinds = [[e[0] if e[0] == "batch_isend_irecv" else e for e in log]
             for log in logs]
    if any(k != kinds[0] for k in kinds):
        return False
    for i, e in enumerate(logs[0]):
        if e[0] != "batch_isend_irecv":
            continue
        sent, got = [], []
        for r, log in enumerate(logs):
            for kind, _, peer, shape, dtype, _ in log[i][1]:
                (sent if kind == "isend" else got).append(
                    (r, peer, shape, dtype) if kind == "isend"
                    else (peer, r, shape, dtype))
        if sorted(sent) != sorted(got):
            return False
    return True


@pytest.mark.parametrize("name", CASES)
def test_every_step_makes_the_same_collectives(job, name):
    ranks = [r[name] for r in job()["ranks"]]
    for got in ranks:
        assert got["error"] is None, got["error"]
        assert got["step"] == K and len(got["steps"]) == K
        first = got["steps"][0]
        assert first and all(s == first for s in got["steps"][1:])
        per = got["per_step"]
        assert got["delta"] == {k: K * v for k, v in per.items()}
        kinds = [e[0] for e in first]
        assert per["dp.all_reduce_calls"] == 2
        assert per["sp.halo_calls"] == kinds.count("batch_isend_irecv")
        assert per["sp.gather_calls"] >= kinds.count("all_gather")
        assert len(first) == sum(v for k, v in per.items()
                                 if k.endswith("_calls"))
    assert _paired([got["steps"][0] for got in ranks])
    if name.startswith("dp_"):
        assert [e[:2] for e in ranks[0]["steps"][0]] == \
            [("all_reduce", (0, 1))] * 2


def test_halos_and_gathers_take_the_device_tensor_code(job):
    """Over gloo on the CPU the halo exchange is one batch_isend_irecv of
    the CPU tensors and the gathers gather them where they are, as NCCL
    does a card's."""
    for got in (r["sp_sggan_resnet"] for r in job()["ranks"]):
        halos = [e for e in got["steps"][0] if e[0] == "batch_isend_irecv"]
        assert halos and got["via_host"] and not any(got["via_host"])
        assert {op[0] for e in halos for op in e[1]} == {"isend", "irecv"}
    for got in (r["sp_pix2pix"] for r in job()["ranks"]):
        gathers = [e for e in got["steps"][0] if e[0] == "all_gather"]
        assert gathers and got["per_step"]["sp.gather_calls"] > 0
        assert not any(got["via_host"])


def test_ranks_import_no_jax(job):
    for rc, text in job()["outs"]:
        assert "OK imported no JAX module: True" in text
