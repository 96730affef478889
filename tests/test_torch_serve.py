"""Port parity of the HTTP service: sggan_tpu_torch.serve on the CPU
serves the checkpoint under --checkpoint_dir as the JAX service does.  A
JAX train state under --gen_ema, saved by the JAX package's checkpoint
and bridged into a port checkpoint, gives the JAX service's pixels within
1 level (uint8 truncation of f32 outputs that differ in summation order),
with the same routes; the EMA shadow, the --which_direction generator of
the cycle mode and the pix2pix moving stats are what both serve."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.config import Config  # noqa: E402
from sggan_tpu_torch import config as tconfig  # noqa: E402
from sggan_tpu_torch import serve as tsrv  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from sggan_tpu_torch.utils.bridge import train_state_from_jax  # noqa: E402


def _cfg(tmp_path, **kw):
    return Config(dataset_dir=str(tmp_path), image_height=32, image_width=32,
                  ngf=4, ndf=4, segment_class=8, compute_dtype="float32",
                  use_resnet=True, checkpoint_dir=str(tmp_path / "ckpt"),
                  **kw)


def _port_cfg(cfg, **kw):
    return tconfig.Config(**dataclasses.asdict(cfg)).replace(**kw)


def _png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/translate",
                                 data=body,
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req) as r:
        return np.asarray(Image.open(io.BytesIO(r.read())))


def _perturb(tree, rng, scale):
    """Every leaf moved by noise of ``scale`` times its spread (at least
    ``scale``), so the served nets are no init."""
    import jax

    def move(a):
        a = np.asarray(a)
        s = scale * max(float(a.std()), 1.0 if a.ndim == 1 else 0.0)
        return (a + s * rng.standard_normal(a.shape)).astype(a.dtype)
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def jax_service(tmp_path_factory):
    """The JAX service at the test config under --gen_ema, serving a
    checkpoint that the JAX package's ``ckpt.save`` wrote: its init with
    the parameters and the EMA shadow moved apart.  Returns (cfg, the
    service, the numpy state).

    The service's Trainer draws its init eagerly, one XLA program per
    threefry draw, each through XLA's LLVM passes: ~30 s on one core.
    Here the same init runs as one program without those passes, which
    gives the same draws; both the checkpoint and the service take it."""
    import jax

    from sggan_tpu import serve as jsrv
    from sggan_tpu.train import step as jstep
    from sggan_tpu.train import trainer as jtrainer
    from sggan_tpu.utils import checkpoint as jckpt

    states = []

    def init_state(cfg, key, **kw):
        if not states:
            init = jax.jit(lambda k: jstep.init_state(cfg, k, **kw))
            states.append(init.lower(key).compile(
                {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True})(key))
        return states[0]

    cfg = _cfg(tmp_path_factory.mktemp("serve"), gen_ema=0.999)
    rng = np.random.default_rng(3)
    state = jax.tree.map(np.asarray, init_state(
        cfg, jax.random.PRNGKey(cfg.data_seed)))
    state = state._replace(gen_params=_perturb(state.gen_params, rng, 0.2),
                           ema=_perturb(state.gen_params, rng, 0.2))
    jckpt.save(state, cfg.checkpoint_dir, cfg.dataset_dir, 3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_state", init_state)
        svc = jsrv._Service(cfg)
    assert len(states) == 1 and svc.loaded is True
    return cfg, svc, state


def test_http_service_serves_jax_pixels(jax_service, tmp_path):
    """The same train state, saved by each package's checkpoint: the port's
    service loads its own and serves the JAX service's pixels, the EMA
    shadow's and not the trained parameters'."""
    jcfg, jsvc, state = jax_service
    cfg = _port_cfg(jcfg, checkpoint_dir=str(tmp_path / "pt"))
    tstate = train_state_from_jax(cfg, state)
    tckpt.save(tstate, cfg.checkpoint_dir, cfg.dataset_dir, 3)
    img = np.random.default_rng(1).integers(0, 255, (48, 64, 3), np.uint8)
    expect = np.asarray(Image.open(io.BytesIO(jsvc.translate_png(_png(img)))))
    httpd = tsrv.serve(cfg, port=0, block=False, device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["ok"] and health["image_size"] == [32, 32]
        assert health["backend"] == "cpu" and health["artifact"] is False
        assert health["checkpoint_loaded"] is True
        got = _post(port, _png(img))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, b"not an image")
        assert e.value.code == 400
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()
    assert got.shape == (32, 32, 3) and got.dtype == np.uint8
    np.testing.assert_allclose(got.astype(int), expect.astype(int), atol=1)
    # the trained parameters would have served other pixels
    x = np.asarray(Image.fromarray(img).resize((32, 32), Image.BILINEAR),
                   np.float32)[None] / 255.0
    raw = evaluate.generate(cfg, tstate.gen_params, x, torch.device("cpu"))
    assert np.abs(((raw[0] + 1.0) / 2.0 * 255).astype(np.uint8).astype(int)
                  - got.astype(int)).max() > 8


def _port_checkpoint(cfg, seed=5):
    """A port train state with every generator parameter and moving stat
    moved off its init, saved under ``cfg.checkpoint_dir``; returns it."""
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in state.gen_params.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=g)
                   * max(p.std().item() if p.dim() > 1 else 1.0, 0.0))
        for stats in state.gen_bn.values():
            stats["moving_mean"].add_(torch.randn(
                stats["moving_mean"].shape, generator=g))
            stats["moving_var"].mul_(0.25 + 4 * torch.rand(
                stats["moving_var"].shape, generator=g))
    tckpt.save(state, cfg.checkpoint_dir, cfg.dataset_dir, 2)
    return state


@pytest.mark.parametrize("case", ["cycle_BtoA", "pix2pix_bn"])
def test_service_serves_the_checkpoints_generator(case, tmp_path):
    """Port only: the cycle mode's BtoA generator, and the pix2pix
    generator on its trained moving stats, as the port's --phase test
    runs them (``evaluate.generate``), and not the other direction or
    the fresh stats."""
    if case == "cycle_BtoA":
        cfg = _port_cfg(_cfg(tmp_path), loss_mode="cycle",
                        which_direction="BtoA")
    else:
        cfg = _port_cfg(_cfg(tmp_path), use_resnet=False, use_pix2pix=True)
    state = _port_checkpoint(cfg)
    svc = tsrv._Service(cfg, device="cpu")
    assert svc.loaded is True
    x = np.random.default_rng(2).random((1, 32, 32, 3), np.float32)
    got = svc._fn(x)
    dev = torch.device("cpu")
    if case == "cycle_BtoA":
        want = evaluate.generate(cfg, state.gen_params["b2a"], x, dev)
        other = evaluate.generate(cfg, state.gen_params["a2b"], x, dev)
    else:
        want = evaluate.generate(cfg, state.gen_params, x, dev,
                                 gen_bn=state.gen_bn)
        other = evaluate.generate(cfg, state.gen_params, x, dev,
                                  gen_bn=state.gen_params.init_bn_state())
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - other).max() > 0.01


def test_fresh_init_service_reports_no_checkpoint(tmp_path):
    svc = tsrv._Service(_cfg(tmp_path), device="cpu")
    assert svc.loaded is False and svc.device_name == "cpu"
    out = svc.translate_png(_png(np.zeros((8, 8, 3), np.uint8)))
    assert np.asarray(Image.open(io.BytesIO(out))).shape == (32, 32, 3)


def test_cli_serves_on_cuda(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(tsrv, "serve", lambda cfg, port, device, artifact:
                        seen.update(cfg=cfg, port=port, device=device,
                                    artifact=artifact))
    tsrv.main(["--port", "8123", "--use_resnet", "--img_height", "256",
               "--img_width", "512", "--dataset_dir", str(tmp_path)])
    assert seen["port"] == 8123 and seen["device"] == "cuda"
    assert seen["cfg"].image_size == (256, 512) and seen["cfg"].use_resnet
    assert seen["artifact"] is None


def test_cli_export_requires_artifact(capsys):
    with pytest.raises(SystemExit) as e:
        tsrv.main(["--use_resnet", "--export"], device="cpu")
    assert e.value.code == 2
    assert "--export requires --artifact" in capsys.readouterr().err


def test_cuda_device_without_gpu_is_an_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsrv._Service(_cfg(tmp_path), device="cuda")


def test_port_imports_no_jax(tmp_path):
    """The card's machine has no JAX: the port (and so chip_smoke.py)
    must serve a forward and take a train step without importing it or
    any module of the JAX package."""
    code = f"""
import sys
import numpy as np
import torch
from sggan_tpu_torch import serve
from sggan_tpu_torch.config import Config
from sggan_tpu_torch.train import pool, step
cfg = Config(dataset_dir={str(tmp_path)!r}, image_height=16, image_width=16,
             ngf=2, compute_dtype="float32", use_resnet=True)
svc = serve._Service(cfg, device="cpu")
y = svc._fn(np.full((1, 16, 16, 3), 0.5, np.float32))
assert y.shape == (1, 16, 16, 3) and np.isfinite(y).all()
cfg = cfg.replace(image_height=32, image_width=32, ngf=4, ndf=4,
                  segment_class=4, loss_mode="sggan", max_size=2)
g = torch.Generator().manual_seed(0)
state = step.init_state(cfg, g, device="cpu")
batch = {{"real_a": torch.rand(1, 32, 32, 3, generator=g),
          "seg_a": torch.rand(1, 32, 32, 3, generator=g),
          "mask_a": torch.eye(4)[torch.randint(0, 4, (1, 4, 4), generator=g)]}}
state, m = step.build_step_fn(cfg)(state, batch, 1e-3,
                                   pool.pool_draws(g, 1, 2))
assert state.step == 1 and all(np.isfinite(v.item()) for v in m.values())
bad = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
             or m.startswith(("jax.", "sggan_tpu.")))
assert not bad, bad
print("ok")
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=root)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
