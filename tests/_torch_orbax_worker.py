"""One rank of the port's resume from a JAX package Orbax checkpoint over
gloo (``tests/test_torch_orbax.py`` starts it with
``tests/_torch_dist.py``; not collected).  Imports torch and the port,
never JAX.

    python tests/_torch_orbax_worker.py resume <work_dir> <flag>...

``python -m sggan_tpu_torch.main --phase train --continue_train --epoch
1`` with the flags given (``--mesh_data 2`` or ``--mesh_space 2``), its
checkpoint directory ``<work_dir>/ckpt`` holding the JAX package's
``cp-NNNN`` directories.  The state that ``checkpoint.load`` returns on
this rank, before any step, goes to ``<work_dir>/loaded<rank>.pt``:
both nets' state dicts, BN and Adam states, the pool buffers (this
rank's rows or block), its count, the step and the EMA.
"""

import os
import sys

import torch

torch.set_num_threads(1)


def resume(work: str, *flags: str) -> None:
    import torch.distributed as dist

    from sggan_tpu_torch import main as tmain
    from sggan_tpu_torch.parallel import distributed
    from sggan_tpu_torch.utils import checkpoint as ckpt

    distributed.initialize(device_kind="cpu")
    rank = dist.get_rank()
    load = ckpt.load

    def kept(*args, **kw):
        st = load(*args, **kw)
        if st is not None:
            torch.save({"gen": st.gen_params.state_dict(),
                        "disc": st.disc_params.state_dict(),
                        "gen_bn": st.gen_bn, "disc_bn": st.disc_bn,
                        "g_opt": st.g_opt._asdict(),
                        "d_opt": st.d_opt._asdict(),
                        "pool": st.pool.buffer, "count": st.pool.count,
                        "step": st.step, "ema": st.ema},
                       os.path.join(work, f"loaded{rank}.pt"))
        return st
    ckpt.load = kept
    dirs = [x for d in ("sample", "test", "log")
            for x in (f"--{d}_dir", os.path.join(work, f"{d}{rank}"))]
    tmain.main(["--phase", "train", "--continue_train", "--epoch", "1",
                "--checkpoint_dir", os.path.join(work, "ckpt"), *flags,
                *dirs], device="cpu")
    distributed.shutdown()
    banned = [m for m in sys.modules if m.split(".")[0] in (
        "jax", "sggan_tpu", "orbax", "tensorstore", "zstandard",
        "ml_dtypes")]
    print(f"OK rank {rank} imported none of JAX's modules: {not banned} "
          f"{banned[:3]}", flush=True)


def main() -> None:
    job, *args = sys.argv[1:]
    assert job == "resume", job
    resume(*args)


if __name__ == "__main__":
    main()
