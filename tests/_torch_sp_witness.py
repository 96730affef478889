"""The f64 witness of the spatial cycle step's gradients (not collected):
for each batch seed, the first step of ``tests/test_torch_spatial_step.py``'s
cycle case (the ResNet cycle step at space 2, its identity and gradient
terms on) from the JAX package's ``init_sp_cycle_state``, in five forms:
the JAX ``make_sp_step_body`` on 2 CPU devices in f32 (compiled as the test
compiles it) and in f64 (``jax_enable_x64``, the JAX package's f32 casts
made f64); the port's two gloo ranks in f32 (``tests/_torch_sp_worker.py
steps``, what the test runs); and the port's one-process cycle step on the
whole plane (patch-head discriminators) in f32 and in f64 (its f32 casts
made f64).  Prints, per seed, the losses; whether the ranks' gradients
meet the test's limit against JAX's f32 (rtol 2e-3 plus the cycle case's
absolute floor of each tensor's largest, element by element); and, over
all tensors, the largest difference between each pair of forms as a share
of that tensor's largest f64 gradient, with the tensor where it is.

    python tests/_torch_sp_witness.py [seed,seed,...]   # default 3
"""

import os
import pickle
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (8 CPU devices, before JAX starts)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_spatial_step as T  # noqa: E402
from _torch_dp_witness import port_f64  # noqa: E402
from _torch_dist import run_ranks  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel import make_mesh  # noqa: E402
from sggan_tpu.parallel.spatial_step import (init_sp_cycle_state,  # noqa
                                             make_sp_step_body, place_sp,
                                             shard_sp_batch)
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import _leaves  # noqa: E402

NAME = "cycle_s2"
KW = T.CASES[NAME]
PAIRS = (("ranks32", "jax32"), ("ranks32", "one32"), ("ranks32", "one64"),
         ("jax32", "jax64"), ("jax64", "one64"))
B1 = Config(**KW).beta1


def _mu_grads(mu) -> dict:
    return {f"{opt}/{k}": np.asarray(v, np.float64) / (1 - B1)
            for opt, tree in mu.items() for k, v in _leaves(tree)}


def jax_grads(js, batch) -> dict:
    """The JAX sp step's first-step gradients (Adam's first moments over
    1 - beta1) and generator loss."""
    mesh = make_mesh(data=1, space=2, devices=jax.devices()[:2])
    step = jax.jit(make_sp_step_body(JConfig(**KW, batch_size=T.B_ROW),
                                     mesh))
    args = (place_sp(js, mesh), shard_sp_batch(batch, mesh),
            jnp.asarray(T.LR, jnp.float32), T.RNGS[0])
    out, jm = step.lower(*args).compile(T.FAST)(*args)
    g = _mu_grads({"g_opt": out.g_opt.mu, "d_opt": out.d_opt.mu})
    g["loss"] = float(jm["gen_loss"])
    return g


def one_grads(case, f64: bool) -> dict:
    """The port's one-process cycle step on the whole plane, from the same
    state and draws, as ``test_sp_first_step_matches_one_process`` runs
    it."""
    one = Config(**{**case["kw"], "mesh_space": 1})
    st = bridge.train_state_from_jax(one, case["states"][0], head="patch")
    dt = torch.float64 if f64 else torch.float32
    if f64:
        for net in (st.gen_params, st.disc_params):
            for m in net.values():
                m.double()
        st = st._replace(pool=st.pool._replace(buffer={
            k: v.double() for k, v in st.pool.buffer.items()}))
    batch = {k: torch.from_numpy(v).to(dt)
             for k, v in case["batches"][0].items()}
    b = next(iter(batch.values())).shape[0]
    draws = tpool.pool_draws(torch.Generator().manual_seed(0), b, T.POOL)
    m, g, dg = tcycle.losses_and_grads(one, st, batch, draws._replace(
        u=draws.u.to(dt)))[:3]
    out = {f"{opt}/{k}": np.asarray(v, np.float64) for opt, tree in
           (("g_opt", g), ("d_opt", dg))
           for k, v in _leaves(bridge.params_to_jax(
               {n: t.detach() for n, t in tree.items()}))}
    out["loss"] = m["gen_loss"].item()
    return out


def ranks_grads(case) -> dict:
    """The port's two gloo ranks, the test's worker, first step."""
    one_step = dict(case, states=case["states"][:1],
                    batches=case["batches"][:1], draws=case["draws"][:1],
                    masks=case["masks"][:1])
    with tempfile.TemporaryDirectory() as work:
        with open(os.path.join(work, "cases.pkl"), "wb") as f:
            pickle.dump({NAME: one_step}, f)
        outs = run_ranks("steps", [os.path.join(work, "cases.pkl"), work],
                         world=2, worker="_torch_sp_worker.py")
        assert all(rc == 0 for rc, _ in outs), outs
        with open(os.path.join(work, "rank0.pkl"), "rb") as f:
            tm, ts = pickle.load(f)[NAME]["steps"][0]
    g = _mu_grads({"g_opt": ts["g_opt"]["mu"], "d_opt": ts["d_opt"]["mu"]})
    g["loss"] = tm["gen_loss"]
    return g


def main(seeds) -> None:
    torch.set_num_threads(1)
    runs, cases = {}, {}
    for s in seeds:
        T.SEED[NAME] = s
        case, ref = T._jax_case(NAME, KW)()
        cases[s] = case
        jm, js = ref[0]
        runs[s] = {"jax32": {**_mu_grads({"g_opt": js.g_opt.mu,
                                          "d_opt": js.d_opt.mu}),
                             "loss": jm["gen_loss"]},
                   "ranks32": ranks_grads(case),
                   "one32": one_grads(case, False)}
        with port_f64():
            runs[s]["one64"] = one_grads(case, True)
    # the JAX package in f64: x64 on, its f32 casts made f64
    jcfg = JConfig(**KW, batch_size=T.B_ROW)
    js = T._compile(lambda k: init_sp_cycle_state(jcfg, k, n_data=1),
                    jax.random.PRNGKey(9))
    jax.config.update("jax_enable_x64", True)
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        js64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64)
                            if jnp.issubdtype(v.dtype, jnp.floating) else v,
                            js)
        for s in seeds:
            batch = {k: v.astype(np.float64)
                     for k, v in cases[s]["batches"][0].items()}
            runs[s]["jax64"] = jax_grads(js64, batch)
    finally:
        jnp.float32 = f32
        jax.config.update("jax_enable_x64", False)
    for s in seeds:
        r = runs[s]
        holds = all(np.all(
            np.abs(r["ranks32"][k] - r["jax32"][k])
            <= T.GRAD_TOL["rtol"] * np.abs(r["jax32"][k])
            + T.CYCLE_ATOL_OF_MAX * np.abs(r["jax32"][k]).max())
            for k in r["one64"] if k != "loss")
        worst = {}
        for k in r["one64"]:
            ref = np.abs(r["one64"][k]).max() if k != "loss" else 0
            if ref == 0:
                continue
            for a, b in PAIRS:
                d = np.abs(r[a][k] - r[b][k]).max() / ref
                if d >= worst.get((a, b), (-1,))[0]:
                    worst[(a, b)] = (d, k)
        print(f"seed {s}: gen_loss " + " ".join(
            f"{k} {r[k]['loss']!r}" for k in ("jax32", "ranks32", "one32",
                                              "jax64", "one64"))
              + f"; ranks32 at the test's limit of jax32: {holds}")
        for (a, b), (d, k) in worst.items():
            print(f"  |{a} - {b}| {d:.2e} ({k})")


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1
                           else "3").split(",")])
