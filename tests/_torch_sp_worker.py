"""One rank of the port's spatial test jobs (``tests/_torch_dist.py::
run_ranks(..., worker="_torch_sp_worker.py")`` starts it): joins the gloo
process group from the environment, runs one job on this rank's block of
the plane and writes what the parent test checks.  Imports torch and the
port, never JAX.

    python tests/_torch_sp_worker.py ops <cases.pkl> <out_dir>
        every op of ``tests/_torch_sp_common.OPS`` on this rank's block of
        the global inputs: its output and the vjp of this block's
        cotangent (the input's and the parameters')
    python tests/_torch_sp_worker.py nets <cases.pkl> <out_dir>
        the sharded ResNet, U-Net (without and with this shard's masks)
        and patch-head discriminator: output and vjp
    python tests/_torch_sp_worker.py steps <cases.pkl> <out_dir>
        each case's steps from the JAX spatial state bridged at this rank
        (``bridge.train_state_from_jax(..., rank, n_data)``): the losses,
        Adam's first moments and the state with every rank's pool blocks
        (``bridge.train_state_to_jax(state, grid=grid)``)
    python tests/_torch_sp_worker.py trainer <dataset> <work_dir> [p2p]
        ``main.main`` trains the ResNet sggan (with ``p2p``, the pix2pix
        pair in --loss_mode p2p) over 2 ranks (--mesh_space 2), then
        resumes; prints each rank's pool block and state digest
    python tests/_torch_sp_worker.py p2p <cases.pkl> <out_dir>
        the pix2pix pair's sharded ops and nets (``batch_norm_sp``, the
        gathers and scatters, ``generator_pix2pix_sp``,
        ``discriminator_pix2pix_sp``): output, new BN state and vjp
"""

import hashlib
import os
import pickle
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_sp_common import OPS, run_op  # noqa: E402


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return None if t is None else t.detach().numpy().copy()


def _vjp(out, inputs, ct):
    grads = torch.autograd.grad(out, inputs, _t(ct), allow_unused=True)
    return [_np(g) for g in grads]


def ops(cases_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import mesh
    from sggan_tpu_torch.parallel.spatial_step import shard_global

    with open(cases_path, "rb") as f:
        case = pickle.load(f)
    grid = mesh.grid(Config(**case["kw"]))
    inp = {k: _t(v) for k, v in case["inputs"].items()}
    blk = shard_global(inp, grid)
    out = {}
    for name, (needs_w, has_vjp) in OPS.items():
        if needs_w and grid.wspace == 1:
            continue
        x = blk["x"].clone().requires_grad_(True)
        params = {k: _t(v).requires_grad_(True)
                  for k, v in case["params"].get(name, {}).items()}
        y = run_op(name, x, params, blk, grid)
        got = {"y": _np(y)}
        if has_vjp:
            ins = [x, *params.values()]
            if y.dim() == 0:  # a local mean: the global mean's share
                grads = [_np(g) for g in torch.autograd.grad(
                    y / grid.size, ins, allow_unused=True)]
            else:
                ct = shard_global({"c": _t(case["cts"][name])}, grid)["c"]
                grads = _vjp(y, ins, ct.numpy())
            got["dx"] = grads[0]
            got["dparams"] = dict(zip(params, grads[1:]))
        out[name] = got
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    print(f"OK ops rank {dist.get_rank()}", flush=True)


def _nets(cfg, seed: int):
    """The port's generator and patch-head discriminator drawn from
    ``seed`` (the parent draws the same)."""
    from sggan_tpu_torch.train import step as tstep
    g = torch.Generator().manual_seed(seed)
    return tstep.new_generator(cfg, g), tstep.new_discriminator(cfg, g)


def nets(cases_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import mesh, spatial
    from sggan_tpu_torch.parallel.spatial_step import shard_global

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = Config(**case["kw"])
        grid = mesh.grid(cfg)
        gen, disc = _nets(cfg, case["seed"])
        blk = shard_global({k: _t(v) for k, v in case["inputs"].items()},
                           grid)
        x = blk["x"].clone().requires_grad_(True)
        if case["net"] == "disc":
            net = disc
            y = spatial.discriminator_sp(disc, x, blk["mask"], grid,
                                         torch.float32)
        else:
            net = gen
            masks = None
            if case.get("masks") is not None:
                masks = [_t(m) for m in case["masks"][grid.rank]]
            y = spatial.generator_sp(gen, x, grid, torch.float32, masks)
        names, params = zip(*net.named_parameters())
        ct = shard_global({"c": _t(case["ct"])}, grid)["c"]
        grads = _vjp(y, [x, *params], ct.numpy())
        out[name] = {"y": _np(y), "dx": grads[0],
                     "dparams": dict(zip(names, grads[1:]))}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    print(f"OK nets rank {dist.get_rank()}", flush=True)


def steps(cases_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import mesh
    from sggan_tpu_torch.parallel.spatial_step import shard_global
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    from sggan_tpu_torch.utils import bridge

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = Config(**case["kw"])
        grid = mesh.grid(cfg)
        step_fn = tstep.build_step_fn(cfg)
        got = {"steps": []}
        for t, batch in enumerate(case["batches"]):
            state = bridge.train_state_from_jax(
                cfg, case["states"][t], "cpu", grid.rank, cfg.mesh_data)
            blk = shard_global({k: _t(v) for k, v in batch.items()}, grid)
            u, idx = case["draws"][t][grid.d]
            draws = tpool.PoolDraws(_t(u), _t(idx).long())
            masks = case["masks"][t][grid.rank]
            if masks is not None:
                masks = tuple(
                    tuple(_t(m) for m in s) if isinstance(s, (list, tuple))
                    else _t(s) for s in masks)
            state, m = step_fn(state, blk, case["lr"], draws, masks)
            got["steps"].append((
                {k: v.item() for k, v in m.items()},
                bridge.train_state_to_jax(state, grid=grid)))
        out[name] = got
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    print(f"OK steps rank {dist.get_rank()}", flush=True)


def p2p(cases_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import mesh, spatial
    from sggan_tpu_torch.parallel.spatial_step import shard_global

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = Config(**case["kw"])
        grid = mesh.grid(cfg)
        blk = shard_global({k: _t(v) for k, v in case["inputs"].items()},
                           grid)
        state = {k: {n: _t(a) for n, a in v.items()}
                 for k, v in case.get("state", {}).items()}
        kind, train = case["kind"], case.get("train", True)
        x = blk["x"].clone().requires_grad_(True)
        if kind == "bn":
            params = {k: _t(v).requires_grad_(True)
                      for k, v in case["params"].items()}
            y, new = spatial.batch_norm_sp(params, state["bn"], x, grid,
                                           train)
            new, ins, names = {"bn": new}, [x, *params.values()], \
                list(params)
        elif kind == "gather":
            dims = [1, 2] if grid.wspace > 1 else [1]
            y = spatial._scatter(spatial._gather(x, grid).flip(dims), grid)
            new, ins, names = {}, [x], []
        else:
            gen, disc = _nets(cfg, case["seed"])
            if kind == "gen":
                net = gen
                masks = case["masks"][grid.rank]
                masks = None if masks is None else [_t(m) for m in masks]
                y, new = spatial.generator_pix2pix_sp(
                    net, state, x, grid, torch.float32, masks, train)
            else:
                net = disc
                y, new = spatial.discriminator_pix2pix_sp(
                    net, state, blk["inp"], x, grid, torch.float32, train)
            names, params = zip(*net.named_parameters())
            ins, names = [x, *params], list(names)
        # the discriminator's logits are replicated: JAX's vjp through
        # shard_map hands each shard 1 / (S x W) of their cotangent
        ct = _t(case["ct"]) / grid.size if kind == "disc" else \
            shard_global({"c": _t(case["ct"])}, grid)["c"]
        grads = _vjp(y, ins, ct.numpy())
        out[name] = {"y": _np(y), "dx": grads[0],
                     "dparams": dict(zip(names, grads[1:])),
                     "new": {k: {n: _np(t) for n, t in v.items()}
                             for k, v in new.items()}}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    print(f"OK p2p rank {dist.get_rank()}", flush=True)


def _argv(dataset: str, work: str, rank: int, nets: str = "") -> list:
    """The CLI of the 2-rank run, one epoch: the ResNet sggan on the split
    resident on each rank, or with ``nets`` "p2p" the pix2pix pair in the
    p2p mode on the host iterator (``--device_dataset_mb 0``)."""
    mode = ["--use_pix2pix", "--loss_mode", "p2p", "--device_dataset_mb",
            "0"] if nets == "p2p" else \
        ["--use_resnet", "--loss_mode", "sggan", "--max_size", "4"]
    return ["--dataset_dir", dataset, "--img_height", "32", "--img_width",
            "32", "--ngf", "4", "--ndf", "4", "--segment_class", "8",
            "--batch_size", "2", "--compute_dtype", "float32", *mode,
            "--epoch", "1", "--print_freq", "1", "--mesh_space", "2",
            "--checkpoint_dir", os.path.join(work, "ckpt"),
            "--sample_dir", os.path.join(work, f"sample{rank}"),
            "--test_dir", os.path.join(work, f"test{rank}"),
            "--log_dir", os.path.join(work, f"logs{rank}")]


def trainer(dataset: str, work: str, nets: str = "") -> None:
    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.train.step import state_tensors
    from sggan_tpu_torch.train.trainer import Trainer

    distributed.initialize(device_kind="cpu")
    rank = dist.get_rank()
    runs = []
    train = Trainer.train

    def kept(self):
        runs.append((self, train(self)))
        return runs[-1][1]
    Trainer.train = kept

    def report(what: str) -> None:
        tr, last = runs[-1]
        digest = hashlib.sha256(b"".join(
            t.detach().numpy().tobytes() for k, t in sorted(
                state_tensors(tr.state).items())
            if not k.startswith("pool."))).hexdigest()
        with open(os.path.join(work, f"{what}{rank}.pkl"), "wb") as f:
            pickle.dump({k: v.numpy().copy() for k, v in
                         tr.state.pool.buffer.items()}, f)
        print(f"OK {what} rank {rank} step {tr.state.step} count "
              f"{tr.state.pool.count} gen_loss {last['gen_loss']!r} "
              f"digest {digest}", flush=True)

    argv = _argv(dataset, work, rank, nets)
    tmain.main(["--phase", "train", *argv], device="cpu")
    report("trainer")
    tmain.main(["--phase", "train", "--continue_train", *argv],
               device="cpu")
    report("resume")
    distributed.shutdown()


def main() -> None:
    job, *args = sys.argv[1:]
    if job == "trainer":
        trainer(*args)
    else:
        import torch.distributed as dist
        dist.init_process_group("gloo")
        try:
            {"ops": ops, "nets": nets, "steps": steps, "p2p": p2p}[job](
                *args)
        finally:
            dist.destroy_process_group()
    banned = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "sggan_tpu.")) or m == "sggan_tpu"]
    print(f"OK imported no JAX module: {not banned} {banned[:3]}", flush=True)


if __name__ == "__main__":
    main()
