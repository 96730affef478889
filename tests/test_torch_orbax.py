"""The port's import of the JAX package's Orbax checkpoints
(``sggan_tpu_torch/utils/{zstd,ocdbt,orbax}.py`` under
``utils/checkpoint.py``) against the JAX package itself.

Each JAX state is ``init_state``'s tree (``jax.eval_shape``: no JAX RNG,
no compile) filled from numpy, saved by the JAX package's own
``sggan_tpu.utils.checkpoint.save``.  The port's ``checkpoint.load`` of it
must equal ``bridge.train_state_from_jax`` of the JAX package's own
``load`` bit for bit: every parameter, BN state, Adam moment and count,
EMA tensor, pool buffer and count, and the step.  The cases: the sggan
ResNet with ``--gen_ema`` at bf16 (a bf16 pool), the pix2pix pair with
both nets' BN states, the cycle mode, ``--compat_fake_history``, and
two resumes through the port's CLI over two gloo ranks: ``--mesh_data
2`` and ``--mesh_space 2`` states placed on the virtual devices as the
JAX trainer places them, so that their pools are saved as several
chunks, of which each rank takes its rows or its block.

Also: ``latest_epoch`` and ``source`` across both formats; a resume from
a JAX checkpoint through the CLI numbers its ``cp-NNNN.pt`` after it and
leaves the JAX directories as they were after more than ``MAX_TO_KEEP``
saves; a mismatched ``--gen_ema`` and the layouts the reader does not
read raise, by name.
"""

import hashlib
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from _torch_dist import start_ranks, wait_ranks, write_dataset  # noqa: E402
from sggan_tpu import config as jconfig  # noqa: E402
from sggan_tpu.parallel import make_mesh, replicate  # noqa: E402
from sggan_tpu.parallel.spatial_step import init_sp_state, place_sp  # noqa: E402
from sggan_tpu.train import step as jstep  # noqa: E402
from sggan_tpu.train.cycle import init_cycle_state  # noqa: E402
from sggan_tpu.utils import checkpoint as jckpt  # noqa: E402
from sggan_tpu_torch import config as tconfig  # noqa: E402
from sggan_tpu_torch import main as tmain  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge, orbax  # noqa: E402
from sggan_tpu_torch.utils import checkpoint as ckpt  # noqa: E402

SMALL = ["--img_height", "32", "--img_width", "64", "--ngf", "8", "--ndf",
         "8", "--segment_class", "4", "--batch_size", "1", "--max_size",
         "3", "--compute_dtype", "float32"]
CASES = {
    "sggan_resnet_ema_bf16": ["--use_resnet", "--loss_mode", "sggan",
                              "--gen_ema", "0.99", "--compute_dtype",
                              "bfloat16"],
    "pix2pix_p2p": ["--use_pix2pix", "--loss_mode", "p2p", "--img_width",
                    "32"],
    "cycle_resnet": ["--use_resnet", "--loss_mode", "cycle"],
    "compat_fake_history": ["--loss_mode", "p2p", "--compat_fake_history",
                            "--batch_size", "2"],
}
# the gloo resumes' CLI: the dataset's 64x64 PNGs at 32x32, 8 classes
CLI = ["--img_height", "32", "--img_width", "32", "--ngf", "4", "--ndf",
       "4", "--segment_class", "8", "--batch_size", "2", "--compute_dtype",
       "float32", "--use_resnet", "--loss_mode", "sggan", "--max_size", "3",
       "--print_freq", "1"]
JAX_EPOCH = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_state(jcfg, init=jstep.init_state, seed=0, **kw):
    """``init``'s tree filled from numpy: floats uniform in [-0.5, 0.5),
    integers (the counts, the step) in [1, 50).  Numpy leaves save as the
    multi-process trainer's do (one ``ocdbt.process_0``, whole arrays,
    and orbax's quickest path); the dp and sp states are placed on the
    mesh as the trainer places them (sharded: several chunks)."""
    shapes = jax.eval_shape(lambda: init(jcfg, jax.random.PRNGKey(0), **kw))
    r = np.random.default_rng(seed)

    def fill(s):
        if np.issubdtype(s.dtype, np.integer):
            return r.integers(1, 50, s.shape).astype(s.dtype)
        return (r.random(s.shape, np.float32) - 0.5).astype(s.dtype)
    return jax.tree.map(fill, shapes)


def save_jax(state, root, epoch=JAX_EPOCH):
    jckpt.save(state, str(root), "city", epoch)


def jax_reference(state, root, cfg, **kw):
    """The JAX package's load of ``root``, bridged: what the port must
    give."""
    loaded = jckpt.load(state, str(root), "city")
    return bridge.train_state_from_jax(
        cfg, jax.tree.map(np.asarray, loaded), "cpu", **kw)


def _bits(t):
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return str(t.dtype), tuple(t.shape), \
        t.reshape(-1).view(torch.uint8).numpy().tobytes()


def flat(st) -> dict:
    """Every tensor and number of a port ``TrainState`` by name, as (dtype,
    shape, bytes)."""
    out = {f"gen.{k}": v for k, v in st.gen_params.state_dict().items()}
    out.update({f"disc.{k}": v for k, v in
                st.disc_params.state_dict().items()})
    for name, bn in (("gen_bn", st.gen_bn), ("disc_bn", st.disc_bn)):
        out.update({f"{name}.{k}.{n}": t for k, v in bn.items()
                    for n, t in v.items()})
    for name, opt in (("g_opt", st.g_opt), ("d_opt", st.d_opt)):
        out[f"{name}.count"] = opt.count
        for m in ("mu", "nu"):
            out.update({f"{name}.{m}.{k}": v
                        for k, v in getattr(opt, m).items()})
    out.update({f"pool.{k}": v for k, v in st.pool.buffer.items()})
    out["pool.count"] = torch.tensor(int(st.pool.count), dtype=torch.int32)
    out["step"] = torch.tensor(int(st.step), dtype=torch.int32)
    out.update({f"ema.{k}": v for k, v in (st.ema or {}).items()})
    return {k: _bits(v) for k, v in out.items()}


def assert_same(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    bad = [k for k in ref if got[k] != ref[k]]
    assert not bad, f"{len(bad)} tensors differ: {bad[:5]}"


@pytest.fixture(scope="module", autouse=True)
def jobs(tmp_path_factory):
    """The --mesh_data 2 and --mesh_space 2 JAX states, saved, and their
    two-rank resumes through the port's CLI, started first so that they
    run while the rest of the module does."""
    root = tmp_path_factory.mktemp("datasets") / "city"
    write_dataset(root, 2, 1)
    out = {}
    for mode, flags, make in (
            ("dp", ["--mesh_data", "2"], lambda c: replicate(
                jax_state(c, seed=5, n_data=2), make_mesh(data=2))),
            ("sp", ["--mesh_space", "2"], lambda c: place_sp(
                jax_state(c, init_sp_state, seed=6, n_data=1),
                make_mesh(data=1, space=2)))):
        argv = ["--dataset_dir", str(root), *CLI, *flags]
        jcfg = jconfig.parse_args(argv)
        work = tmp_path_factory.mktemp(mode)
        state = make(jcfg)
        save_jax(state, work / "ckpt")
        out[mode] = dict(state=state, work=work,
                         cfg=tconfig.parse_args(argv),
                         procs=start_ranks("resume", [work, *argv],
                                           worker="_torch_orbax_worker.py"))
    out["dataset"] = str(root)
    yield out
    for v in out.values():  # a job whose test did not wait for it
        for p in v["procs"] if isinstance(v, dict) else ():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.mark.parametrize("case", CASES)
def test_load_equals_the_jax_load_bridged(case, tmp_path):
    argv = SMALL + CASES[case]
    jcfg, cfg = jconfig.parse_args(argv), tconfig.parse_args(argv)
    init = init_cycle_state if case.startswith("cycle") else jstep.init_state
    state = jax_state(jcfg, init)
    save_jax(state, tmp_path)
    template = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    got = ckpt.load(template, str(tmp_path), "city")
    ref = jax_reference(state, tmp_path, cfg)
    assert_same(flat(got), flat(ref))
    if cfg.compute_dtype == "bfloat16":
        assert got.pool.buffer["fake"].dtype == torch.bfloat16
    if cfg.use_pix2pix:
        assert got.gen_bn and got.disc_bn
    # the nets hold the loaded parameters
    assert_same({k: _bits(v) for k, v in
                 template.gen_params.state_dict().items()},
                {k: _bits(v) for k, v in
                 ref.gen_params.state_dict().items()})


@pytest.mark.parametrize("mode", ("dp", "sp"))
def test_two_rank_resume_takes_each_ranks_rows_or_block(mode, jobs):
    job = jobs[mode]
    outs = wait_ranks(job["procs"], 300)
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
        assert f"OK rank {r} imported none of JAX's modules: True" in out
    assert f" [*] Load SUCCESS (JAX Orbax cp-{JAX_EPOCH:04d})" in outs[0][1]
    cfg = job["cfg"]
    for r in range(2):
        saved = torch.load(os.path.join(job["work"], f"loaded{r}.pt"),
                           weights_only=True)
        ref = jax_reference(job["state"], job["work"] / "ckpt", cfg,
                            rank=r, n_data=cfg.mesh_data)
        got = ref._replace(
            gen_params=_module(ref.gen_params, saved["gen"]),
            disc_params=_module(ref.disc_params, saved["disc"]),
            gen_bn=saved["gen_bn"], disc_bn=saved["disc_bn"],
            g_opt=ref.g_opt._replace(**saved["g_opt"]),
            d_opt=ref.d_opt._replace(**saved["d_opt"]),
            pool=ref.pool._replace(buffer=saved["pool"],
                                   count=saved["count"]),
            step=saved["step"], ema=saved["ema"])
        assert_same(flat(got), flat(ref))
        # dp: this rank's 3 of the 6 saved slots; sp: its half of the rows
        assert tuple(saved["pool"]["fake"].shape) == (
            (3, 32, 32, 3) if mode == "dp" else (3, 16, 32, 3))
    ck = os.path.join(job["work"], "ckpt", "city")
    for part in ckpt.PARTS:
        names = sorted(os.listdir(os.path.join(ck, part)))
        assert names == [f"cp-{JAX_EPOCH:04d}", f"cp-{JAX_EPOCH + 1:04d}.pt"]


def _module(like, state_dict):
    import copy
    m = copy.deepcopy(like)
    m.load_state_dict(state_dict)
    return m


def test_latest_epoch_and_source_across_formats(tmp_path):
    # the pix2pix pair: the fewest leaves, so the quickest saves
    argv = SMALL + CASES["pix2pix_p2p"]
    jcfg, cfg = jconfig.parse_args(argv), tconfig.parse_args(argv)
    state = jax_state(jcfg)
    port = tstep.init_state(cfg, torch.Generator().manual_seed(0), "cpu")
    root = str(tmp_path)
    assert ckpt.latest_epoch(root, "city") is None
    assert ckpt.source(root, "city") is None
    save_jax(state, root, 4)
    assert (ckpt.latest_epoch(root, "city"), ckpt.source(root, "city")) \
        == (4, "JAX Orbax cp-0004")
    ckpt.save(port, root, "city", 4)  # a tie: the port's own wins
    assert ckpt.source(root, "city") == "cp-0004.pt"
    save_jax(state, root, 6)
    assert (ckpt.latest_epoch(root, "city"), ckpt.source(root, "city")) \
        == (6, "JAX Orbax cp-0006")
    assert ckpt.source(root, "city", 4) == "cp-0004.pt"
    ckpt.save(port, root, "city", 7)
    assert ckpt.source(root, "city") == "cp-0007.pt"
    # a JAX number without all three parts is not a checkpoint
    save_jax(state, root, 9)
    os.rename(os.path.join(root, "city", "train", "cp-0009"),
              os.path.join(root, "city", "train", "cp-0009.tmp"))
    assert ckpt.latest_epoch(root, "city") == 7


def _tree_digest(path: str) -> str:
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(path)):
        for f in sorted(files):
            h.update(os.path.relpath(os.path.join(d, f), path).encode())
            with open(os.path.join(d, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def test_resume_numbers_after_the_jax_checkpoint_and_keeps_it(
        jobs, tmp_path, capsys):
    argv = ["--dataset_dir", jobs["dataset"], *CLI, "--train_size", "1",
            "--batch_size", "1", "--save_freq", "1"]
    jcfg = jconfig.parse_args(argv)
    save_jax(jax_state(jcfg, seed=3), tmp_path / "checkpoint", 7)
    ck = tmp_path / "checkpoint" / "city"
    before = {p: _tree_digest(str(ck / p / "cp-0007")) for p in ckpt.PARTS}
    epochs = ckpt.MAX_TO_KEEP + 1
    tmain.main(["--phase", "train", "--continue_train", "--epoch",
                str(epochs), *argv, *(x for d in ("checkpoint", "sample",
                                                  "test", "log")
                                      for x in (f"--{d}_dir",
                                                str(tmp_path / d)))],
               device="cpu")
    assert " [*] Load SUCCESS (JAX Orbax cp-0007)" in capsys.readouterr().out
    kept = [f"cp-{e:04d}.pt" for e in range(8 + epochs - ckpt.MAX_TO_KEEP,
                                            8 + epochs)]
    for p in ckpt.PARTS:
        assert sorted(os.listdir(ck / p)) == ["cp-0007", *kept]
        assert _tree_digest(str(ck / p / "cp-0007")) == before[p]
    assert ckpt.source(str(tmp_path / "checkpoint"), "city") == kept[-1]


def test_gen_ema_mismatch_raises(tmp_path):
    argv = SMALL + CASES["pix2pix_p2p"] + ["--gen_ema", "0.99"]
    jcfg, cfg = jconfig.parse_args(argv), tconfig.parse_args(argv)
    save_jax(jax_state(jcfg), tmp_path)
    no_ema = cfg.replace(gen_ema=0.0)
    template = tstep.init_state(no_ema, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="has an EMA shadow"):
        ckpt.load(template, str(tmp_path), "city")
    save_jax(jax_state(jconfig.parse_args(SMALL + CASES["pix2pix_p2p"])),
             tmp_path, JAX_EPOCH + 1)
    template = tstep.init_state(cfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="has no EMA shadow"):
        ckpt.load(template, str(tmp_path), "city")


def test_layouts_not_read_are_refused_by_name(tmp_path):
    save_jax(jax_state(jconfig.parse_args(SMALL + CASES["pix2pix_p2p"])),
             tmp_path)
    item = str(tmp_path / "city" / "train" / f"cp-{JAX_EPOCH:04d}")
    assert set(orbax.read(item)) == {"pool_buffer", "pool_count", "step"}
    meta_path = os.path.join(item, "_METADATA")
    with open(meta_path) as f:
        meta = json.load(f)
    for key, value, match in (("use_zarr3", True, "use_zarr3 is true"),
                              ("use_ocdbt", False, "use_ocdbt is false")):
        with open(meta_path, "w") as f:
            json.dump({**meta, key: value}, f)
        with pytest.raises(ValueError, match=match):
            orbax.read(item)
    leaf = next(iter(meta["tree_metadata"].values()))
    leaf["value_metadata"]["value_type"] = "string"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="value type 'string' is not read"):
        orbax.read(item)
