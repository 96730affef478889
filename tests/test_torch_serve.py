"""Port parity of the HTTP service: sggan_tpu_torch.serve on the CPU,
loaded with the JAX service's own generator weights through the bridge,
serves the JAX service's pixels within 1 level (uint8 truncation of f32
outputs that differ in summation order), with the same routes."""

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
from sggan_tpu_torch import serve as tsrv  # noqa: E402
from sggan_tpu_torch.utils.bridge import params_from_jax  # noqa: E402


def _cfg(tmp_path):
    return Config(dataset_dir=str(tmp_path), image_height=32, image_width=32,
                  ngf=4, ndf=4, segment_class=8, compute_dtype="float32",
                  use_resnet=True, checkpoint_dir=str(tmp_path / "ckpt"))


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


@pytest.fixture(scope="module")
def jax_service(tmp_path_factory):
    """The JAX service at the test config (fresh init from data_seed: no
    checkpoint) and its generator weights as a state_dict.

    The service's Trainer draws its init eagerly, one XLA program per
    threefry draw, each through XLA's LLVM passes: ~30 s on one core.
    Here the same init runs as one program without those passes, which
    gives the same draws; the weights are read from that one init."""
    import jax

    from sggan_tpu import serve as jsrv
    from sggan_tpu.train import step as jstep
    from sggan_tpu.train import trainer as jtrainer

    states = []

    def init_state(cfg, key, **kw):
        init = jax.jit(lambda k: jstep.init_state(cfg, k, **kw))
        states.append(init.lower(key).compile(
            {"xla_backend_optimization_level": 0,
             "xla_llvm_disable_expensive_passes": True})(key))
        return states[-1]

    cfg = _cfg(tmp_path_factory.mktemp("serve"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "init_state", init_state)
        svc = jsrv._Service(cfg)
    assert len(states) == 1 and svc.loaded is False
    return cfg, svc, params_from_jax(states[0].gen_params)


def test_http_service_serves_jax_pixels(jax_service):
    cfg, jsvc, sd = jax_service
    img = np.random.default_rng(1).integers(0, 255, (48, 64, 3), np.uint8)
    expect = np.asarray(Image.open(io.BytesIO(jsvc.translate_png(_png(img)))))
    httpd = tsrv.serve(cfg, port=0, block=False, device="cpu", state_dict=sd)
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


def test_fresh_init_service_reports_no_checkpoint(tmp_path):
    svc = tsrv._Service(_cfg(tmp_path), device="cpu")
    assert svc.loaded is False and svc.device_name == "cpu"
    out = svc.translate_png(_png(np.zeros((8, 8, 3), np.uint8)))
    assert np.asarray(Image.open(io.BytesIO(out))).shape == (32, 32, 3)


@pytest.mark.parametrize("flag", [["--export"], ["--artifact", "gen.pt2"]])
def test_cli_refuses_export_and_artifact(flag, capsys):
    with pytest.raises(SystemExit) as e:
        tsrv.main(["--use_resnet", *flag])
    assert e.value.code == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_cli_serves_on_cuda(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(tsrv, "serve", lambda cfg, port, device:
                        seen.update(cfg=cfg, port=port, device=device))
    tsrv.main(["--port", "8123", "--use_resnet", "--img_height", "256",
               "--img_width", "512", "--dataset_dir", str(tmp_path)])
    assert seen["port"] == 8123 and seen["device"] == "cuda"
    assert seen["cfg"].image_size == (256, 512) and seen["cfg"].use_resnet


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
