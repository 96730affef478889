"""The port's deployment artifact (``sggan_tpu_torch/utils/export.py``,
``serve.export_artifact``) on the CPU.

Every instance norm of an exported generator is one node of the
registered op ``sggan_tpu_torch.instance_norm``, and no graph holds the
plain version's reductions in its place: 23 nodes in the ResNet, 15 in
the U-Net, 0 in the pix2pix generator.  The artifact gives the eager
``evaluate.generate`` output (with the test-time input convention and
sharpening baked in) and, on the same weights, the JAX package's
``jax.export`` artifact within the generator parity test's atol 1e-4.
The CLI's ``--export`` writes a file that a process holding only
``utils.export`` serves."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.request

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu_torch import serve as tsrv  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.ops import norm as tnorm  # noqa: E402
from sggan_tpu_torch.train import evaluate  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from sggan_tpu_torch.utils import export as gexport  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1_OP = "sggan_tpu_torch.instance_norm.default"
# the plain instance norm's moments are reductions over H x W; nothing
# else in an inference forward reduces (batch norm reads moving stats)
PLAIN_REDUCTIONS = ("aten.sum", "aten.mean", "aten.var")
NETS = {"resnet": (dict(use_resnet=True), 23),
        "unet": ({}, 15),
        "pix2pix": (dict(use_pix2pix=True), 0)}


def _cfg(tmp_path, **kw):
    return Config(dataset_dir=str(tmp_path), image_height=32, image_width=32,
                  ngf=4, ndf=4, segment_class=4, compute_dtype="float32",
                  checkpoint_dir=str(tmp_path / "ckpt"), **kw)


def _gen(cfg, seed=0):
    return tstep.new_generator(cfg, torch.Generator().manual_seed(seed))


def _x(seed=1):
    return np.random.default_rng(seed).random((1, 32, 32, 3), np.float32)


def _k1_nodes_and_reductions(program):
    ops = gexport.graph_ops(program)
    return (ops.get(K1_OP, 0),
            sum(n for op, n in ops.items() if op.startswith(PLAIN_REDUCTIONS)))


@pytest.fixture(scope="module")
def resnet_artifact(tmp_path_factory):
    """An f32 ResNet's artifact at 32x32, saved: (cfg, gen, path,
    program)."""
    tmp = tmp_path_factory.mktemp("resnet")
    cfg = _cfg(tmp, use_resnet=True)
    gen = _gen(cfg, seed=3)
    program = gexport.export_generator(gen, (32, 32), 1, torch.float32)
    path = str(tmp / "gen.pt2")
    gexport.save(path, program)
    return cfg, gen, path, program


@pytest.mark.parametrize("net", NETS)
def test_graph_has_one_op_node_per_instance_norm(net, tmp_path,
                                                  resnet_artifact):
    flags, sites = NETS[net]
    if net == "resnet":
        program = resnet_artifact[3]
    else:
        gen = _gen(_cfg(tmp_path, **flags))
        program = gexport.export_generator(gen, (32, 32), 1, torch.float32,
                                           gen.init_bn_state())
    assert _k1_nodes_and_reductions(program) == (sites, 0)


def test_autograd_function_would_fail_the_count(tmp_path, monkeypatch):
    """The same export with every norm through the training path's
    autograd Function: torch.export traces into its plain ops, so the
    count finds no op node and the reductions in their place."""
    monkeypatch.setattr(tnorm, "instance_norm_op",
                        lambda *a: tnorm._InstanceNorm.apply(*a))
    program = gexport.export_generator(_gen(_cfg(tmp_path)), (32, 32), 1,
                                       torch.float32)
    k1, reductions = _k1_nodes_and_reductions(program)
    assert k1 == 0 and reductions >= 15


@pytest.mark.parametrize("net,flags", [
    ("resnet", dict(test_uint8_input=True, gen_ema=0.999)),
    ("unet", dict(test_uint8_input=False, eval_sharpen=float("inf"))),
    ("pix2pix", dict(test_uint8_input=True, eval_sharpen=3.0))])
def test_artifact_matches_eager_generate(net, flags, tmp_path):
    """``export_artifact`` of the checkpoint under --checkpoint_dir, loaded
    and run, against ``evaluate.generate`` of the same nets: equal up to
    the graph's op order (the same ops on the same inputs)."""
    cfg = _cfg(tmp_path, **NETS[net][0], **flags)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        for p in state.gen_params.parameters():
            p.mul_(1.5)
    if state.ema is not None:
        state = state._replace(ema={k: 0.5 * v for k, v in state.ema.items()})
    tckpt.save(state, cfg.checkpoint_dir, cfg.dataset_dir, 0)
    path = str(tmp_path / "gen.pt2")
    assert tsrv.export_artifact(cfg, path, "cpu") is True
    art = gexport.load(path, "cpu")
    assert art.meta == {"checkpoint_loaded": True}
    assert art.input_shapes == [(1, 32, 32, 3)]
    x = _x()
    got = art(x).numpy()
    gen = state.gen_params
    if state.ema is not None:
        gen.load_state_dict(state.ema)
    want = evaluate.generate(cfg, gen, x, torch.device("cpu"),
                             gen_bn=state.gen_bn)
    assert got.shape == want.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_artifact_matches_the_jax_artifact(resnet_artifact):
    """One f32 ResNet on the same weights: the port's export against the
    JAX package's ``export_generator`` (StableHLO), each loaded and run,
    within the generator parity test's atol 1e-4.  The JAX program is
    compiled without XLA's LLVM passes (ROADMAP, test budget)."""
    import jax
    import jax.numpy as jnp
    from jax import export as jexport

    from sggan_tpu.models import generator_resnet as jgen
    from sggan_tpu.utils import export as jx
    from sggan_tpu_torch.utils.bridge import params_to_jax

    _, gen, path, _ = resnet_artifact
    x = _x(seed=4)
    got = gexport.load(path)(x).numpy()
    blob = jx.export_generator(jgen.apply, params_to_jax(gen.state_dict()),
                               (32, 32), 1, compute_dtype=jnp.float32)
    call = jexport.deserialize(blob).call
    ref = jax.jit(call).lower(x).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True,
         "xla_cpu_use_fusion_emitters": False})(x)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-4)


def test_artifact_runs_only_on_its_device(resnet_artifact):
    path = resnet_artifact[2]
    with pytest.raises(ValueError, match="exported on cpu"):
        gexport.load(path, "cuda")
    art = gexport.load(path)
    assert art.device == torch.device("cpu") and art.meta == {}
    with pytest.raises(ValueError, match="runs on cpu"):
        art(torch.zeros(1, 32, 32, 3, device="meta"))


def test_cli_export_then_artifact(tmp_path, capsys):
    """--export writes the artifact of the checkpoint; a process that
    imports only ``utils.export`` (no model, trainer or JAX module) runs
    it; the service with --artifact says so in /healthz and serves the
    checkpoint service's PNG within 1 level."""
    flags = ["--use_resnet", "--img_height", "32", "--img_width", "32",
             "--ngf", "4", "--ndf", "4", "--segment_class", "4",
             "--compute_dtype", "float32", "--dataset_dir", str(tmp_path),
             "--checkpoint_dir", str(tmp_path / "ckpt"),
             "--test_uint8_input"]
    cfg = _cfg(tmp_path, use_resnet=True, test_uint8_input=True)
    state = tstep.init_state(cfg, torch.Generator().manual_seed(2), "cpu")
    tckpt.save(state, cfg.checkpoint_dir, cfg.dataset_dir, 1)
    path = str(tmp_path / "gen.pt2")
    tsrv.main(["--export", "--artifact", path, *flags], device="cpu")
    assert "checkpoint_loaded=True" in capsys.readouterr().out
    x = _x(seed=6)
    np.save(tmp_path / "x.npy", x)
    code = f"""
import sys
import numpy as np
from sggan_tpu_torch.utils import export
y = export.load({path!r}, "cpu")(np.load({str(tmp_path / "x.npy")!r}))
np.save({str(tmp_path / "y.npy")!r}, y.numpy())
bad = sorted(m for m in sys.modules if m in ("jax", "sggan_tpu")
             or m.startswith(("jax.", "sggan_tpu.", "sggan_tpu_torch.models",
                              "sggan_tpu_torch.train")))
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    want = evaluate.generate(cfg, state.gen_params, x, torch.device("cpu"))
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"), want, rtol=0,
                               atol=1e-6)

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsrv, "serve", lambda cfg, port, device, artifact:
                   seen.update(device=device, artifact=artifact))
        tsrv.main(["--artifact", path, *flags])
    assert seen == {"device": "cuda", "artifact": path}
    img = np.random.default_rng(7).integers(0, 255, (40, 24, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    expect = np.asarray(Image.open(io.BytesIO(
        tsrv._Service(cfg, device="cpu").translate_png(buf.getvalue()))))
    httpd = tsrv.serve(cfg, port=0, block=False, device="cpu",
                       artifact=path)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        req = urllib.request.Request(f"http://127.0.0.1:{port}/translate",
                                     data=buf.getvalue())
        with urllib.request.urlopen(req) as r:
            got = np.asarray(Image.open(io.BytesIO(r.read())))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert health["artifact"] is True and health["checkpoint_loaded"] is True
    np.testing.assert_allclose(got.astype(int), expect.astype(int), atol=1)


def test_artifact_of_another_size_is_refused(resnet_artifact):
    cfg, _, path, _ = resnet_artifact
    with pytest.raises(ValueError, match=r"not the configured \(1, 64, 32"):
        tsrv._Service(cfg.replace(image_height=64), device="cpu",
                      artifact=path)
