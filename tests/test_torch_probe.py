"""The memory probe (``utils/hbm.py``) and ``cycle_recon_eval`` of the
port on the CPU:

* ``_parse_oom`` on torch's CUDA OOM message, and ``probe_memory``'s keys
  for each kind at a tiny config (the verdict is the card's);
* ``cycle_recon_eval``: the four scores of ``recon_scores`` against the
  JAX U-Net applies on the same parameters, bridged (f32, rel 1e-5), and
  the CLI on a checkpoint: its JSON line and both PNG strips."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.models import generator_unet as junet  # noqa: E402
from sggan_tpu_torch import cycle_recon_eval as recon  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge, hbm  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_step import FAST  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------- memory probe

OOM = ("CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
       "capacity of 79.19 GiB of which 1.23 GiB is free. Including "
       "non-PyTorch memory, this process has 77.95 GiB memory in use. Of the "
       "allocated memory 76.50 GiB is allocated by PyTorch, and 512.00 MiB "
       "is reserved by PyTorch but unallocated.")


def test_parse_oom_reads_torchs_message():
    g = 2 ** 30
    assert hbm._parse_oom(OOM) == {
        "oom_tried_bytes": 2 * g, "oom_limit_bytes": int(79.19 * g),
        "oom_free_bytes": int(1.23 * g), "oom_used_bytes": int(77.95 * g),
        "oom_allocated_bytes": int(76.5 * g)}
    assert hbm._parse_oom("Tried to allocate 20.00 MiB") == {
        "oom_tried_bytes": 20 * 2 ** 20}
    # the form of a process the driver does not see as its own
    other = OOM.replace("Including non-PyTorch memory, this process has",
                        "Process 1 has")
    assert hbm._parse_oom(other)["oom_used_bytes"] == int(77.95 * g)
    assert hbm._parse_oom("no numbers") == {}
    err = RuntimeError("capture ended")
    err.__context__ = torch.cuda.OutOfMemoryError(OOM)
    assert hbm._oom_of(err) is err.__context__
    assert hbm._oom_of(RuntimeError("other")) is None


@pytest.mark.parametrize("kind,cfg_kw", [
    ("step", {}), ("scan", {"scan_steps": 2}), ("eval", {}),
    ("auto", {"loss_mode": "cycle", "scan_steps": 1})])
def test_probe_memory_runs_each_kind_on_the_cpu(tmp_path, kind, cfg_kw,
                                                capsys):
    cfg = Config(image_height=16, image_width=16, ngf=2, ndf=2,
                 segment_class=4, batch_size=1, compute_dtype="float32",
                 use_resnet=True, loss_mode="sggan", max_size=2,
                 dataset_dir=str(tmp_path)).replace(**cfg_kw)
    out = hbm.probe_memory(cfg, source_hw=(24, 32), n_items=2, kind=kind,
                           device="cpu")
    want = "step" if kind == "auto" else kind
    assert out == {"kind": want, "backend": "cpu", "source_hw": [24, 32],
                   "n_items": 2}
    if kind == "step":
        got = hbm.main(["--img_height", "16", "--img_width", "16", "--ngf",
                        "2", "--ndf", "2", "--segment_class", "4",
                        "--batch_size", "1", "--use_resnet", "--probe_kind",
                        "eval", "--probe_items", "3"], device="cpu")
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
            == got == {"kind": "eval", "backend": "cpu",
                       "source_hw": [16, 16], "n_items": 3}
    with pytest.raises(ValueError, match="kind"):
        hbm.probe_memory(cfg, kind="compile", device="cpu")


# ------------------------------------------------------ cycle recon eval


def test_cycle_recon_scores_match_the_jax_generators(tmp_path, capsys):
    """``recon_scores`` against the JAX U-Net's applies on the same two
    generators' parameters; then the CLI on a checkpoint of that state
    prints its JSON and writes both strips."""
    kw = dict(loss_mode="cycle", image_height=32, image_width=32, ngf=4,
              ndf=4, segment_class=4, compute_dtype="float32",
              batch_size=1)
    cfg = Config(**kw)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    a = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(size=(3, 32, 32, 3)).astype(np.float32)
    rec, _ = recon.recon_scores(cfg, recon.eval_generators(state),
                                torch.from_numpy(a), torch.from_numpy(b))
    gp = bridge.params_to_jax(state.gen_params.state_dict())
    apply = jax.jit(lambda p, x: junet.apply(
        p, x, compute_dtype=jnp.float32)).lower(gp["a2b"], a).compile(FAST)
    l1 = lambda x, y: float(jnp.mean(jnp.abs(x - y)))  # noqa: E731
    fake_b = apply(gp["a2b"], a)
    fake_a = apply(gp["b2a"], b)
    ref = {"cyc_a_l1": l1(apply(gp["b2a"], fake_b), a),
           "idt_a_l1": l1(apply(gp["b2a"], a), a),
           "cyc_b_l1": l1(apply(gp["a2b"], fake_a), b),
           "idt_b_l1": l1(apply(gp["a2b"], b), b)}
    assert rec["n_a"] == rec["n_b"] == 3
    for k, v in ref.items():
        assert rec[k] == pytest.approx(v, rel=1e-5), k

    run = tmp_path / "run"
    data = run / "datasets" / "city"
    for split, arr in (("testA", a), ("testB", b)):
        os.makedirs(data / split)
        for i, im in enumerate(arr):
            Image.fromarray((im * 255).astype(np.uint8)).save(
                data / split / f"x{i}.png")
    ckpt.save(state, str(run / "checkpoint"), "city", 0)
    cwd = os.getcwd()
    try:
        got = recon.main([str(run), *(f"{k}={v}" for k, v in kw.items()),
                          "dataset_dir=city"], device="cpu")
    finally:
        os.chdir(cwd)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("RECON ")]
    assert json.loads(line[0][6:]).keys() == got.keys() == {
        "n_a", "n_b", "cyc_a_l1", "idt_a_l1", "cyc_b_l1", "idt_b_l1"}
    assert all(np.isfinite(v) for v in got.values())
    for name in ("a_fake_recon.png", "b_fake_recon.png"):
        assert Image.open(run / "recon" / name).size == (96, 32)
