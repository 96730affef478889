"""Port parity of the CLI's default nets, the U-Net generator with the
semantic discriminator, against the JAX package on the CPU: f32, ngf and
ndf 4, 32x32, 8 classes.

* the U-Net forward on the JAX package's weights through the bridge, with
  and without dropout (the port fed the keep masks that JAX draws from
  its key): atol 1e-4, as tests/test_torch_generator.py holds the ResNet;
  the golden fixture at its policy (rtol 2e-3 / atol 2e-4);
* ``dropout`` fed JAX's mask: equal to JAX's ``dropout``, bitwise;
* one p2p train step with the U-Net against the JAX step, and
  ``sigmoid_ce``'s gradient at 0: ``tests/test_torch_unet_step.py``;
* ``conv2d_transpose`` at stride 1: the padded form equals the full
  transposed conv cropped by SAME's pads;
* the trainer, ``main`` and ``/translate`` with no net flag.

The JAX sides are compiled as one program each without XLA's LLVM passes,
as tests/test_torch_step.py compiles its step."""

import io
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.models import generator_unet as junet  # noqa: E402
from sggan_tpu.ops import layers as jlayers  # noqa: E402
from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch import models, serve  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.models.discriminator import Discriminator  # noqa: E402
from sggan_tpu_torch.models.generator_unet import GeneratorUnet  # noqa: E402
from sggan_tpu_torch.ops import layers  # noqa: E402
from sggan_tpu_torch.train import evaluate, fused  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from test_torch_step import FAST, _leaves  # noqa: E402
from test_torch_trainer import (N_CLASS, _assert_states_equal, _cfg,  # noqa: E402,F401
                                dataset)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "unet.npy")
B, H, W = 2, 32, 32
KW = dict(image_height=H, image_width=W, ngf=4, ndf=4, segment_class=N_CLASS,
          batch_size=B, compute_dtype="float32", loss_mode="p2p",
          use_resnet=False, use_pix2pix=False, dropout_mode="intended")
LR = 1e-3
RNG = jax.random.PRNGKey(21)
STEP_SEED = 2  # a batch with no generator gate within f32 noise of 0
# the port's default-net CLI flags (no net or loss flag)
CLI = ["--img_height", str(H), "--img_width", str(W), "--ngf", "4", "--ndf",
       "4", "--segment_class", str(N_CLASS), "--batch_size", "2",
       "--compute_dtype", "float32", "--print_freq", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """4-channel nets at 32x32: one torch thread runs them as fast as
    several and does not contend with the other test workers (restored
    after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


@pytest.fixture(scope="module")
def golden_case():
    """The params and input of test_golden._case("unet") (ngf 4, 16x16),
    drawn as one program without XLA's LLVM passes (the same draws)."""
    def draws():
        return (junet.init(jax.random.PRNGKey(42), ngf=4),
                jax.random.uniform(jax.random.PRNGKey(7), (1, 16, 16, 3)))
    p, x = _compile(draws)
    return jax.tree.map(np.array, p), np.array(x)


def _port(p):
    gen = GeneratorUnet(ngf=4)
    gen.load_state_dict(bridge.params_from_jax(p))
    return gen


def _unet_masks(rng, shape):
    """The keep masks the JAX U-Net draws for d1-d3 from ``rng``
    (generator_unet.py:96, layers.dropout)."""
    def draw(r):
        return [jax.random.bernoulli(k, 0.5, shape)
                for k in jax.random.split(r, 3)]
    return [torch.from_numpy(np.array(m)) for m in _compile(draw, rng)]


@pytest.mark.parametrize("drop", [False, True], ids=["deterministic",
                                                     "dropout"])
def test_unet_matches_jax(golden_case, drop):
    p, _ = golden_case
    x = np.random.default_rng(0).uniform(size=(B, H, W, 3)).astype(np.float32)
    ref = _compile(lambda p, x: junet.apply(
        p, x, compute_dtype=jnp.float32, rng=RNG if drop else None,
        deterministic=not drop), p, x)
    masks = _unet_masks(RNG, (B, H, W, 32)) if drop else None
    with torch.no_grad():
        got, st = _port(p)(torch.from_numpy(x), {}, torch.float32, masks,
                           train=drop)
    assert st == {}
    assert got.dtype == torch.float32 and got.shape == (B, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    if drop:  # the masks matter: without them the output moves
        with torch.no_grad():
            plain, _ = _port(p)(torch.from_numpy(x), {}, torch.float32)
        assert (plain - got).abs().max() > 1e-2


def test_unet_matches_golden_fixture(golden_case):
    p, x = golden_case
    with torch.no_grad():
        got, _ = _port(p)(torch.from_numpy(x.copy()), {})
    np.testing.assert_allclose(got.numpy(), np.load(GOLDEN), rtol=2e-3,
                               atol=2e-4)


def test_unet_bridge_round_trips_every_key(golden_case):
    p, _ = golden_case
    sd = bridge.params_from_jax(p)
    assert set(sd) == set(GeneratorUnet(ngf=4).state_dict())
    assert len([k for k in sd if k.endswith("_in.gamma")]) == 15
    back = bridge.params_to_jax(sd)
    for path, v in jax.tree_util.tree_leaves_with_path(p):
        node = back
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, np.asarray(v))
    # conv HWIO -> OIHW, conv-transpose (kh, kw, cout, cin) -> (cin, cout)
    assert sd["e2.w"].shape == (8, 4, 3, 3) and sd["d5.w"].shape == (32, 16,
                                                                     3, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_matches_jax_with_its_mask(dtype):
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(1).standard_normal((2, 5, 7, 6)) \
        .astype(np.float32)
    jx = jnp.asarray(x, dtype)
    ref = jlayers.dropout(key, jx, 0.5, deterministic=False)
    mask = jax.random.bernoulli(key, 0.5, x.shape)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = layers.dropout(tx, 0.5, torch.from_numpy(np.array(mask)))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    assert layers.dropout(tx, 0.5, None) is tx
    with pytest.raises(ValueError, match="mask"):
        layers.dropout(tx, 0.5, torch.ones(2, 5, 7, 1, dtype=torch.bool))


def test_dropout_masks_follow_the_generator():
    g = torch.Generator().manual_seed(0)
    a, b = layers.dropout_masks(g, [(4, 8, 8, 16), (2, 3)], 0.5)
    assert a.dtype == torch.bool and a.shape == (4, 8, 8, 16)
    assert b.shape == (2, 3) and 0.4 < a.float().mean() < 0.6
    again = layers.dropout_masks(torch.Generator().manual_seed(0),
                                 [(4, 8, 8, 16)], 0.5)[0]
    assert torch.equal(a, again)


@pytest.mark.parametrize("size", [(7, 9), (8, 12)], ids=["odd", "even"])
@pytest.mark.parametrize("cin,cout", [(3, 5), (16, 8)])
def test_conv_transpose_stride1_padding_equals_the_crop(size, cin, cout):
    """At stride 1 and k 3 SAME's pads are (1, 1): the padded transposed
    conv equals the full one cropped by them, which the strided path
    keeps."""
    r = np.random.default_rng(2)
    x = torch.from_numpy(r.standard_normal((2, *size, cin))
                         .astype(np.float32))
    p = {"w": torch.from_numpy(r.standard_normal((cin, cout, 3, 3))
                               .astype(np.float32)),
         "b": torch.from_numpy(r.standard_normal(cout).astype(np.float32))}
    got = layers.conv2d_transpose(p, x, 1, "SAME")
    full = torch.nn.functional.conv_transpose2d(x.permute(0, 3, 1, 2),
                                                p["w"])
    want = full[:, :, 1:1 + size[0], 1:1 + size[1]].permute(0, 2, 3, 1) \
        + p["b"]
    assert got.shape == (2, *size, cout) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw,gen,disc", [
    ({}, "GeneratorUnet", "Discriminator"),
    ({"use_resnet": True}, "GeneratorResnet", "Discriminator"),
    ({"use_pix2pix": True}, "GeneratorPix2pix", "DiscriminatorPix2pix")])
def test_build_selects_the_nets_as_the_jax_package(kw, gen, disc):
    from sggan_tpu import models as jmodels
    g, d = models.build(Config(**kw))
    jg, jd = jmodels.build(JConfig(**kw))
    assert (g.__name__, d.__name__) == (gen, disc)
    assert jg.__name__.endswith(g.__module__.rsplit(".", 1)[1])
    assert jd.__name__.endswith(d.__module__.rsplit(".", 1)[1])


NETS = pytest.mark.parametrize("kw", [{}, {"use_resnet": True},
                                      {"use_pix2pix": True}],
                               ids=["unet", "resnet", "pix2pix"])


@NETS
def test_every_generator_takes_and_returns_its_state(kw):
    """One signature for every generator: ``(x, state, cd, masks, train)
    -> (y, state)``; the instance-norm nets take and return {}, the
    pix2pix net its moving stats (as they came, in inference); dropout
    masks for the U-Net and pix2pix only."""
    cfg = Config(**{**KW, **kw})
    gen = tstep.new_generator(cfg, torch.Generator().manual_seed(0))
    st = gen.init_bn_state()
    x = torch.rand(B, H, W, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y, new = gen(x, st, torch.float32)
    assert y.dtype == torch.float32 and y.shape == (B, H, W, 3)
    assert (st == {}) == (not cfg.use_pix2pix)
    assert new.keys() == st.keys() and all(
        new[k][n] is st[k][n] for k in st for n in st[k])
    shapes = gen.drop_shapes(B, H, W)
    assert len(shapes) == (0 if cfg.use_resnet else 3)
    assert gen.drop_rate == (0.0 if cfg.use_resnet else 0.5)
    masks = tstep.dropout_masks(cfg, gen, torch.Generator(), B)
    assert (masks is None) == cfg.use_resnet


@NETS
def test_nets_are_drawn_generator_first(kw):
    """``init_state`` draws the generator, then the discriminator, from
    one torch generator; ``build_generator`` draws the generator alone,
    from ``--data_seed``, to the same values."""
    cfg = Config(**{**KW, **kw, "data_seed": 3})
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(3)
    gen, disc = tstep.new_generator(cfg, g), tstep.new_discriminator(cfg, g)
    for a, b in ((ts.gen_params, gen), (ts.disc_params, disc),
                 (ts.gen_params, evaluate.build_generator(cfg))):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def _batch(seed=0):
    r = np.random.default_rng(seed)
    return {"real_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "seg_a": r.uniform(size=(B, H, W, 3)).astype(np.float32),
            "mask_a": np.eye(N_CLASS, dtype=np.float32)[
                r.integers(0, N_CLASS, (B, H // 8, W // 8))]}


def test_dropout_mode_decides_the_masks():
    cfg = Config(**KW)
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(1).items()}
    with pytest.raises(ValueError, match="dropout masks"):
        tstep.losses_and_grads(cfg, ts, tbatch, None)
    masks = tstep.dropout_masks(cfg, ts.gen_params,
                                torch.Generator().manual_seed(1), B)
    assert [m.shape for m in masks] == [(B, H, W, 32)] * 3
    quirk = cfg.replace(dropout_mode="keras_quirk")
    assert tstep.dropout_masks(quirk, ts.gen_params, torch.Generator(),
                               B) is None
    # keras_quirk: deterministic, whatever masks come in
    a = tstep.losses_and_grads(quirk, ts, tbatch, None, masks)[0]
    b = tstep.losses_and_grads(quirk, ts, tbatch, None)[0]
    c = tstep.losses_and_grads(cfg, ts, tbatch, None, masks)[0]
    assert a["gen_loss"] == b["gen_loss"] != c["gen_loss"]
    resnet = cfg.replace(use_resnet=True)
    assert tstep.dropout_masks(resnet, tstep.init_state(
        resnet, torch.Generator(), "cpu").gen_params, torch.Generator(),
        B) is None


def test_trainer_epoch_with_the_default_nets(dataset, tmp_path):
    """One epoch of the default config (the U-Net, p2p, dropout from the
    trainer's device generator) equals the batch assembly, the masks and
    the step composed by hand from the same seeds, bitwise; its
    checkpoint reloads."""
    cfg = _cfg(dataset, tmp_path, use_resnet=False, loss_mode="p2p")
    tr = Trainer(cfg, device="cpu")
    assert isinstance(tr.state.gen_params, GeneratorUnet)
    assert isinstance(tr.state.disc_params, Discriminator)
    tr.train()
    state = tstep.init_state(cfg, torch.Generator().manual_seed(
        cfg.data_seed), "cpu")
    hand = Trainer(cfg, device="cpu")
    ds = hand._maybe_device_dataset()
    make_batch, step_fn = fused.make_batch_fn(cfg), tstep.build_step_fn(cfg)
    from sggan_tpu_torch.data.loader import epoch_order
    order = torch.from_numpy(epoch_order(len(ds), cfg.data_seed, 0))
    for i in range(len(ds) // B):
        draws, pdraws, masks = fused.step_draws(hand, ds.img.shape[1])
        assert masks is not None and len(masks) == 3
        batch = make_batch(ds.img, ds.seg, ds.cls, order[i * B:(i + 1) * B],
                           draws)
        state, _ = step_fn(state, batch, 1e-3, pdraws, masks)
    _assert_states_equal(tr.state, state)
    _assert_states_equal(
        ckpt.load(Trainer(cfg, device="cpu").state, cfg.checkpoint_dir,
                  cfg.dataset_dir), tr.state)


def test_main_trains_and_tests_the_default_nets(dataset, tmp_path,
                                                monkeypatch, capsys):
    """No net or loss flag: the U-Net with the semantic discriminator,
    p2p loss, trains, writes its checkpoint and reloads it in --phase
    test."""
    monkeypatch.chdir(tmp_path)
    tmain.main(["--phase", "train", "--dataset_dir", dataset, "--epoch", "1",
                *CLI], device="cpu")
    out = capsys.readouterr().out
    assert " [*] New training STARTED" in out and "Epoch: [ 0]" in out
    cp = torch.load(tmp_path / "checkpoint" / "city" / "gen" / "cp-0000.pt",
                    weights_only=True)
    assert "e8.w" in cp["params"] and cp["bn"] == {}
    tmain.main(["--phase", "test", "--dataset_dir", dataset, *CLI],
               device="cpu")
    assert " [*] Load SUCCESS" in capsys.readouterr().out
    for i in range(3):
        assert (tmp_path / "test" / f"v{i}.png").is_file()


def test_translate_with_the_unet(tmp_path):
    """/translate on the default generator: the service's pixels are the
    uint8 conversion of evaluate.generate on the same fresh init."""
    cfg = Config(dataset_dir=str(tmp_path), image_height=H, image_width=W,
                 ngf=4, compute_dtype="float32")
    svc = serve._Service(cfg, device="cpu")
    assert isinstance(svc.gen, GeneratorUnet) and svc.gen_bn == {}
    img = np.random.default_rng(3).integers(0, 256, (H, W, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    out = np.asarray(Image.open(io.BytesIO(svc.translate_png(
        buf.getvalue()))))
    want = evaluate.generate(cfg, evaluate.build_generator(cfg),
                             img[None].astype(np.float32) / 255.0, "cpu")
    want = ((want[0] + 1.0) / 2.0 * 255).astype(np.uint8)
    assert out.shape == (H, W, 3)
    np.testing.assert_array_equal(out, want)


def test_unet_train_state_bridge_round_trip():
    """A port TrainState of the default nets to the JAX layouts and back:
    every parameter and Adam moment equal."""
    cfg = Config(**KW)
    ts = tstep.init_state(cfg, torch.Generator().manual_seed(2), "cpu")
    tree = bridge.train_state_to_jax(ts)
    js = jstep.TrainState(tree["gen_params"], tree["gen_bn"],
                          tree["disc_params"], tree["disc_bn"],
                          _Opt(tree["g_opt"]), _Opt(tree["d_opt"]),
                          jpool.PoolState(np.zeros((1, H, W, 3), np.float32),
                                          np.int32(0)), np.int32(0), None)
    back = bridge.train_state_from_jax(cfg, js)
    assert isinstance(back.gen_params, GeneratorUnet)
    _assert_states_equal(back, ts)
    assert dict(_leaves(bridge.train_state_to_jax(back)["gen_params"])) \
        .keys() == dict(_leaves(tree["gen_params"])).keys()


class _Opt:
    """optax's ScaleByAdamState fields from the bridge's dict."""
    def __init__(self, d):
        self.count, self.mu, self.nu = d["count"], d["mu"], d["nu"]
