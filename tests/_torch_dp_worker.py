"""One rank of the port's data-parallel test jobs (``tests/_torch_dist.py``
starts it): joins the gloo process group from the environment, runs one
job and writes what the parent test checks.  Imports torch and the port,
never JAX.

    python tests/_torch_dp_worker.py steps <cases.pkl> <out_dir>
        each case: for each step, the JAX dp state it starts from bridged
        at this rank's pool rows (where the case has one, else the state
        the last step left) and rank 0's state broadcast, then the
        data-parallel step on this rank's shard of the global batch with
        its draws and masks; after each step the losses and the whole
        state with every rank's pool rows
        (``bridge.train_state_to_jax(state, group)``)
    python tests/_torch_dp_worker.py trainer <dataset> <work_dir>
        ``main.main`` trains over 2 ranks (the p2p ResNet, on the host
        iterator: ``--device_dataset_mb 0``), then resumes;
        the global-row preprocess of a host batch; the world-size checks
    python tests/_torch_dp_worker.py resident <dataset> <work_dir>
        ``main.main`` over 2 ranks on the split resident on each rank:
        the p2p ResNet, then the same on the host iterator; the ResNet
        sggan at a batch of 1 doubled, with its pool, in ``--scan_steps``
        chunks of 2 and of 1, each step's losses, the pool and the saves
        recorded, then a resume of the chunked run; the same batch on the
        host iterator (refused); the p2p ResNet where rank 1 cannot build
        the split.  A line ``== <run>`` opens each run's output
    python tests/_torch_dp_worker.py slow_eval <dataset> <work_dir>
            <timeout_s> <eval_s>
        the process group joined with a collectives' timeout of
        ``timeout_s``, then ``main.main`` trains one epoch over 2 ranks
        while the coordinator's eval takes ``eval_s`` longer
    python tests/_torch_dp_worker.py graph <cases.pkl> <out_dir>
        each case's trainer over a resident split made from a seed, one
        epoch in ``--scan_steps`` chunks through ``fused.StepGraph``
        (eager on the CPU): every collective of each step logged (kind,
        group, peer, shape, dtype), each step run where reading a
        tensor's value on the host raises, ``spatial._via_host``'s
        answers, and the collectives' counters recorded a step beside
        their deltas over the epoch
"""

import contextlib
import os
import pickle
import sys

import torch

torch.set_num_threads(1)


def steps(cases_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import dp
    from sggan_tpu_torch.train import pool as tpool
    from sggan_tpu_torch.train import step as tstep
    from sggan_tpu_torch.utils import bridge

    rank, world = dist.get_rank(), dist.get_world_size()
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {}
    for name, case in cases.items():
        cfg = Config(**case["kw"])
        step_fn = tstep.build_step_fn(cfg)
        got = {"steps": []}
        before = dp.reductions, dp.bytes_reduced
        for t, batch in enumerate(case["batches"]):
            if t < len(case["states"]):  # else the last step's state
                state = bridge.train_state_from_jax(
                    cfg, case["states"][t], "cpu", rank, world)
                if t == 0:
                    got["pool_rows_at_init"] = {
                        k: v.clone().numpy()
                        for k, v in state.pool.buffer.items()}
                dp.broadcast_state(state, dist.group.WORLD)
            b = next(iter(batch.values())).shape[0] // world
            shard = {k: torch.from_numpy(v[rank * b:(rank + 1) * b])
                     for k, v in batch.items()}
            draws = case["draws"][t][rank]
            if draws is not None:
                draws = tpool.PoolDraws(torch.from_numpy(draws[0]),
                                        torch.from_numpy(draws[1]).long())
            masks = case["masks"][t][rank]
            if masks is not None:
                masks = tuple(
                    tuple(torch.from_numpy(m) for m in s)
                    if isinstance(s, (list, tuple)) else torch.from_numpy(s)
                    for s in masks)
            state, m = step_fn(state, shard, case["lr"], draws, masks)
            got["steps"].append((
                {k: v.item() for k, v in m.items()},
                bridge.train_state_to_jax(state, dist.group.WORLD)))
        got["reductions"] = (dp.reductions - before[0],
                             dp.bytes_reduced - before[1])
        out[name] = got
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"OK steps rank {rank}", flush=True)


def _argv(dataset: str, work: str, rank: int) -> list:
    """The CLI of the 2-rank p2p ResNet run, one epoch."""
    return ["--dataset_dir", dataset, "--img_height", "32", "--img_width",
            "32", "--ngf", "4", "--ndf", "4", "--segment_class", "8",
            "--batch_size", "4", "--compute_dtype", "float32",
            "--use_resnet", "--loss_mode", "p2p", "--epoch", "1",
            "--print_freq", "1", "--mesh_data", "2",
            "--checkpoint_dir", os.path.join(work, "ckpt"),
            "--sample_dir", os.path.join(work, f"sample{rank}"),
            "--test_dir", os.path.join(work, f"test{rank}"),
            "--log_dir", os.path.join(work, f"logs{rank}")]


def trainer(dataset: str, work: str) -> None:
    import hashlib

    import numpy as np
    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.data.loader import train_iterator
    from sggan_tpu_torch.data.preprocess import (draw_preprocess,
                                                 make_preprocess_train)
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.train.step import state_tensors
    from sggan_tpu_torch.train.trainer import Trainer

    distributed.initialize(device_kind="cpu")
    rank = dist.get_rank()
    runs = []  # each Trainer.train's trainer and result
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
        print(f"OK {what} rank {rank} step {tr.state.step} gen_loss "
              f"{last['gen_loss']!r} digest {digest}", flush=True)

    # the host iterator (the resident split is the ``resident`` job's)
    argv = [*_argv(dataset, work, rank), "--device_dataset_mb", "0"]
    tmain.main(["--phase", "train", *argv], device="cpu")
    report("trainer")
    print(f"OK group still joined {dist.is_initialized()}", flush=True)
    tmain.main(["--phase", "train", "--continue_train", *argv],
               device="cpu")
    report("resume")

    # this rank's rows of the first global batch, preprocessed with the
    # draws of the whole batch
    cfg = Config(dataset_dir=dataset, image_height=32, image_width=32,
                 segment_class=8, batch_size=4)
    raw = next(iter(train_iterator(dataset, 2, cfg.data_seed, epoch=0,
                                   process_index=rank, process_count=2)))
    draws = draw_preprocess(torch.Generator().manual_seed(5), 8,
                            raw["img"].shape[1], cfg.image_size)
    got = make_preprocess_train(cfg)(
        *(torch.from_numpy(raw[k]) for k in ("img", "seg", "cls")), draws,
        torch.from_numpy(raw["aug"]), global_b=8, sample_rows=raw["rows"])
    with open(os.path.join(work, f"pre{rank}.pkl"), "wb") as f:
        pickle.dump({"rows": raw["rows"],
                     **{k: v.numpy() for k, v in got.items()}}, f)

    # --mesh_data (x --mesh_space x --mesh_space_w) must be the world
    # size; a data row's spatial ranks on two hosts (one rank a host here)
    # are refused as the JAX trainer refuses them; the pix2pix nets'
    # spatial trainer builds
    for kw, err, hosts in (
            (dict(mesh_data=4), ValueError, 1),
            (dict(mesh_data=1), ValueError, 1),
            (dict(mesh_data=2, mesh_space=2), ValueError, 1),
            (dict(mesh_data=1, mesh_space=2, use_pix2pix=True,
                  loss_mode="p2p"), None, 1),
            (dict(mesh_data=1, mesh_space=2), ValueError, 2)):
        os.environ["LOCAL_WORLD_SIZE"] = str(2 // hosts)
        if err is None:
            tr = Trainer(cfg.replace(**kw), device="cpu")
            print(f"OK built {sorted(kw.items())}: "
                  f"{type(tr.state.disc_params).__name__}, space "
                  f"{tr.grid.space}, a block of "
                  f"{tuple(tr.state.pool.buffer['fake'].shape[1:3])}",
                  flush=True)
            continue
        try:
            Trainer(cfg.replace(**kw), device="cpu")
        except err as e:
            print(f"OK refused {sorted(kw.items())}: {e}", flush=True)
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    mesh = distributed.global_mesh(device_kind="cpu")
    print(f"OK mesh {mesh.mesh_dim_names} {mesh.size()} coordinator "
          f"{distributed.is_coordinator()}", flush=True)
    np.save(os.path.join(work, f"done{rank}.npy"), np.int32(rank))
    distributed.shutdown()


def resident(dataset: str, work: str) -> None:
    import hashlib

    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.train import trainer as ttrainer
    from sggan_tpu_torch.train.step import state_tensors

    distributed.initialize(device_kind="cpu")
    rank = dist.get_rank()
    Trainer = ttrainer.Trainer
    train, runs = Trainer.train, []

    def kept(self):
        rec = {"losses": [], "saves": []}
        step_fn, save = self.step_fn, self._save

        def recording(*args):
            state, m = step_fn(*args)
            rec["losses"].append((m["gen_loss"].item(),
                                  m["disc_loss"].item()))
            return state, m

        def saving(epoch):
            rec["saves"].append(self.state.step)
            save(epoch)
        self.step_fn, self._save = recording, saving
        runs.append((self, rec))
        rec["last"] = train(self)
        return rec["last"]
    Trainer.train = kept

    def run(name: str, argv: list) -> None:
        print(f"== {name}", flush=True)
        tmain.main(["--phase", "train", *argv], device="cpu")
        tr, rec = runs[-1]
        digest = hashlib.sha256(b"".join(
            t.detach().numpy().tobytes() for k, t in sorted(
                state_tensors(tr.state).items())
            if not k.startswith("pool."))).hexdigest()
        with open(os.path.join(work, f"{name}{rank}.pkl"), "wb") as f:
            pickle.dump({"losses": rec["losses"], "saves": rec["saves"],
                         "step": tr.state.step,
                         "count": tr.state.pool.count,
                         "pool": {k: v.numpy().copy() for k, v in
                                  tr.state.pool.buffer.items()}}, f)
        print(f"OK {name} rank {rank} step {tr.state.step} gen_loss "
              f"{rec['last']['gen_loss']!r} digest {digest}", flush=True)

    def argv(name: str, *extra: str) -> list:
        return [*_argv(dataset, os.path.join(work, name), rank), *extra]

    run("p2p", argv("p2p"))
    run("p2p_host", argv("p2p_host", "--device_dataset_mb", "0"))
    b1 = ["--loss_mode", "sggan", "--batch_size", "1", "--max_size", "2",
          "--train_size", "4", "--print_freq", "2", "--save_freq", "3"]
    for k in ("2", "1"):
        run(f"scan{k}", argv(f"scan{k}", *b1, "--scan_steps", k))
    run("resume", argv("scan2", *b1, "--scan_steps", "2",
                       "--continue_train"))
    print("== b1_host", flush=True)
    try:
        tmain.main(["--phase", "train", *argv("b1_host", *b1,
                                              "--device_dataset_mb", "0")],
                   device="cpu")
    except ValueError as e:
        print(f"OK refused rank {rank}: {e}", flush=True)
    if rank == 1:  # a rank whose split does not stack
        def mixed(*args, **kw):
            raise ValueError("sources of several shapes")
        ttrainer.DeviceDataset = mixed
    run("disagree", argv("disagree"))
    distributed.shutdown()


def slow_eval(dataset: str, work: str, timeout_s: str, eval_s: str) -> None:
    import time

    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.train import evaluate

    distributed.initialize(device_kind="cpu", timeout_s=float(timeout_s))
    rank = dist.get_rank()
    test_during_train = evaluate.test_during_train

    def slow(tr, epoch, writer=None):
        if tr.is_coord:
            time.sleep(float(eval_s))
        return test_during_train(tr, epoch, writer)
    evaluate.test_during_train = slow
    t0 = time.perf_counter()
    tmain.main(["--phase", "train", *_argv(dataset, work, rank)],
               device="cpu")
    print(f"OK slow eval rank {rank} trained in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    distributed.shutdown()


# what a CUDA graph's capture forbids, raised inside the step
HOST_READS = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy")


@contextlib.contextmanager
def no_host_reads():
    """A context in which reading a tensor's value on the host raises,
    but for a tensor that ``torch.tensor`` made there from host values
    (a constant rounded to a dtype: on the card too it never leaves the
    host, so no sync)."""
    saved = {n: getattr(torch.Tensor, n) for n in HOST_READS}
    make = torch.tensor
    host_made = {}  # id -> tensor, kept alive while the context lasts

    def tensor(data, *a, **k):
        t = make(data, *a, **k)
        if t.device.type == "cpu" and not isinstance(data, torch.Tensor):
            host_made[id(t)] = t
        return t

    def refuse(name):
        def read(self, *a, **k):
            if id(self) in host_made:
                return saved[name](self, *a, **k)
            raise RuntimeError(f"Tensor.{name} inside the step")
        return read
    torch.tensor = tensor
    for n in HOST_READS:
        setattr(torch.Tensor, n, refuse(n))
    try:
        yield
    finally:
        torch.tensor = make
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)


@contextlib.contextmanager
def logged_collectives(log: list):
    """A context in which every collective the port makes is appended to
    ``log`` as (kind, group's ranks, peer, shape, dtype, detail), a
    ``batch_isend_irecv`` as one entry of its ops; the collectives a step
    never makes raise."""
    import torch.distributed as dist

    def ranks(group):
        return tuple(dist.get_process_group_ranks(
            dist.group.WORLD if group is None else group))

    def entry(kind, t, group, peer=None, detail=None):
        return (kind, ranks(group), peer, tuple(t.shape), str(t.dtype),
                detail)

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, **kw):
        log.append(entry("all_reduce", t, group, detail=str(op)))
        return saved["all_reduce"](t, op=op, group=group, **kw)

    def all_gather(parts, t, group=None, **kw):
        log.append(entry("all_gather", t, group, detail=len(parts)))
        return saved["all_gather"](parts, t, group=group, **kw)

    def batch_isend_irecv(ops):
        log.append(("batch_isend_irecv", tuple(
            entry(op.op.__name__, op.tensor, op.group, op.peer)
            for op in ops)))
        return saved["batch_isend_irecv"](ops)

    def refused(name):
        def call(*_a, **_k):
            raise RuntimeError(f"dist.{name} inside the step")
        return call
    wrapped = {"all_reduce": all_reduce, "all_gather": all_gather,
               "batch_isend_irecv": batch_isend_irecv,
               **{n: refused(n) for n in ("broadcast", "barrier",
                                          "all_gather_into_tensor",
                                          "reduce_scatter_tensor")}}
    saved = {n: getattr(dist, n) for n in wrapped}
    for n, f in wrapped.items():
        setattr(dist, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def graph(cases_path: str, out_dir: str) -> None:
    import time

    import torch.distributed as dist

    from sggan_tpu_torch.config import Config
    from sggan_tpu_torch.parallel import spatial
    from sggan_tpu_torch.train import fused
    from sggan_tpu_torch.train.trainer import Trainer
    from sggan_tpu_torch.utils.hbm import SyntheticSplit

    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    via_host = spatial._via_host
    out = {}
    for name, kw in cases.items():
        cfg = Config(**kw)
        tr = Trainer(cfg, device="cpu")
        tr.lr.fill_(1e-3)
        tr._timer.start()
        n = cfg.scan_steps * cfg.batch_size  # one chunk
        splits = [SyntheticSplit(n, cfg.image_size, cfg.segment_class,
                                 "cpu", seed) for seed in
                  range(2 if tr.cycle else 1)]
        sg = fused.StepGraph(tr, tuple(splits) if tr.cycle else splits[0],
                             fused.make_batch_fn(cfg, fused.own_rows(tr)))
        step, steps, answers = sg._step, [], []

        def guarded():
            log = []
            with logged_collectives(log), no_host_reads():
                try:
                    torch.ones(1).item()
                except RuntimeError:
                    pass  # the guard holds
                else:
                    raise AssertionError("Tensor.item read a value")
                m = step()
            steps.append(log)
            return m

        def answered(group, like):
            answers.append(via_host(group, like))
            return answers[-1]
        sg._step = guarded
        spatial._via_host = answered
        before = fused.comm_counts()
        error = None
        try:
            fused.run_epoch_chunked(tr, 0, sg, [], [], 0, time.time())
        except RuntimeError as e:
            error = str(e)
        finally:
            spatial._via_host = via_host
        out[name] = {"steps": steps, "error": error,
                     "per_step": sg.comm_calls, "via_host": answers,
                     "delta": {k: v - before[k] for k, v in
                               fused.comm_counts().items()},
                     "step": tr.state.step}
    with open(os.path.join(out_dir, f"rank{dist.get_rank()}.pkl"),
              "wb") as f:
        pickle.dump(out, f)
    print(f"OK graph rank {dist.get_rank()}", flush=True)


def main() -> None:
    job, *args = sys.argv[1:]
    if job in ("steps", "graph"):
        import torch.distributed as dist
        dist.init_process_group("gloo")
        try:
            {"steps": steps, "graph": graph}[job](*args)
        finally:
            dist.destroy_process_group()
    elif job == "trainer":
        trainer(*args)
    elif job == "resident":
        resident(*args)
    else:
        slow_eval(*args)
    banned = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "sggan_tpu.")) or m == "sggan_tpu"]
    print(f"OK imported no JAX module: {not banned} {banned[:3]}", flush=True)


if __name__ == "__main__":
    main()
