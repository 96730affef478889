"""The f64 witness of the data-parallel cycle step's gradients (not
collected): for each batch seed, the first dp step of
``tests/test_torch_dp.py``'s ResNet cycle case, with its identity and
gradient terms on (or "off", as that test runs them), from the JAX
package's ``init_state(n_data=2)``, in four forms: the JAX
``make_dp_step_body`` in f32 (compiled as the test compiles it) and in
f64 (``jax_enable_x64``, the JAX package's f32 casts made f64), and the
port's forward and backward of each shard averaged, in f32 and in f64
(its f32 casts made f64).  The port's f32 average is what its 2-rank
step computes (``tests/test_torch_dp_shards.py`` holds that bitwise).
Prints, per seed, the losses; whether the port's f32 gradient meets the
test's limit for Adam's first moment against JAX's f32 (rtol 1e-3 plus
2e-3 of each tensor's largest, element by element); and, over all
tensors, the largest difference between each pair of forms as a share
of that tensor's largest f64 gradient, with the tensor where it is.

    python tests/_torch_dp_witness.py [seed,seed,...] [on|off]
        # default seeds 0-7, terms on
"""

import contextlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (8 CPU devices, before JAX starts)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_dp as T  # noqa: E402
from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.parallel import make_mesh, replicate, shard_batch  # noqa: E402
from sggan_tpu.parallel.dp import make_dp_step_body  # noqa: E402
from sggan_tpu.train import cycle as jcycle  # noqa: E402
from sggan_tpu_torch.config import Config  # noqa: E402
from sggan_tpu_torch.train import cycle as tcycle  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402
from sggan_tpu_torch.train import step as tstep  # noqa: E402
from sggan_tpu_torch.utils import bridge  # noqa: E402
from test_torch_step import _leaves  # noqa: E402

KW = dict(T.MODES["cycle_resnet"], identity_lambda=5.0, Lg_lambda=5.0)
PAIRS = (("port32", "jax32"), ("port32", "port64"), ("jax32", "jax64"),
         ("jax64", "port64"))


@contextlib.contextmanager
def port_f64():
    fl, dt = torch.Tensor.float, (tstep._dtype, tcycle._dtype)
    torch.Tensor.float = lambda self, *a, **k: self.to(torch.float64)
    tstep._dtype = tcycle._dtype = lambda cfg: torch.float64
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = fl
        tstep._dtype, tcycle._dtype = dt
        torch.set_default_dtype(torch.float32)


def port_grads(state_np, batch, draws, f64: bool) -> dict:
    """The mean over both shards of the port's cycle gradients, in the
    JAX package's tree layout, keyed "g_opt/..." and "d_opt/..."."""
    cfg = Config(**{**KW, "mesh_data": 1})
    dt = torch.float64 if f64 else torch.float32
    b = T.B // T.N
    acc = {}
    for r in range(T.N):
        st = bridge.train_state_from_jax(cfg, state_np, "cpu", r, T.N)
        if f64:
            for net in (st.gen_params, st.disc_params):
                for m in net.values():
                    m.double()
            st = st._replace(pool=st.pool._replace(buffer={
                k: v.double() for k, v in st.pool.buffer.items()}))
        shard = {k: torch.from_numpy(v[r * b:(r + 1) * b]).to(dt)
                 for k, v in batch.items()}
        d = tpool.PoolDraws(torch.from_numpy(draws[r][0]).to(dt),
                            torch.from_numpy(draws[r][1]).long())
        m, g, dg, _ = tcycle.losses_and_grads(cfg, st, shard, d)
        for opt, tree in (("g_opt", g), ("d_opt", dg)):
            for k, v in _leaves(bridge.params_to_jax(tree)):
                acc.setdefault(f"{opt}/{k}", []).append(
                    np.asarray(v, np.float64))
        acc.setdefault("loss", []).append(m["gen_loss"].item())
    return {k: (v[0] + v[1]) / 2 for k, v in acc.items()}


def jax_grads(js, batch) -> dict:
    mesh = make_mesh(data=T.N, space=1, devices=jax.devices()[:T.N])
    step = jax.jit(make_dp_step_body(JConfig(**KW), mesh))
    args = (replicate(js, mesh), shard_batch(batch, mesh),
            jnp.asarray(T.LR, jnp.float32), T.RNGS[0])
    out, jm = step.lower(*args).compile(T.FAST)(*args)
    b1 = Config(**KW).beta1
    g = {f"{opt}/{k}": np.asarray(v, np.float64) / (1 - b1)
         for opt in ("g_opt", "d_opt")
         for k, v in _leaves(getattr(out, opt).mu)}
    g["loss"] = float(jm["gen_loss"])
    return g


def main(seeds, terms: str = "on") -> None:
    if terms == "off":
        KW.update(identity_lambda=0.0, Lg_lambda=0.0)
    jcfg = JConfig(**KW)
    js = T._compile(lambda k: jcycle.init_cycle_state(jcfg, k, n_data=T.N),
                    jax.random.PRNGKey(7))
    draws = [T._shard_draws(KW, T.RNGS[:1])[0][0][r] for r in range(T.N)]
    plain = T._plain(js)
    runs = {}
    for s in seeds:
        batch = T._batch(True, s)
        runs[s] = {"jax32": jax_grads(js, batch),
                   "port32": port_grads(plain, batch, draws, False)}
        with port_f64():
            runs[s]["port64"] = port_grads(plain, batch, draws, True)
    # the JAX package in f64: x64 on, its f32 casts made f64
    jax.config.update("jax_enable_x64", True)
    f32 = jnp.float32
    jnp.float32 = jnp.float64
    try:
        js64 = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64)
                            if jnp.issubdtype(v.dtype, jnp.floating) else v,
                            js)
        for s in seeds:
            batch = {k: v.astype(np.float64) for k, v in
                     T._batch(True, s).items()}
            runs[s]["jax64"] = jax_grads(js64, batch)
    finally:
        jnp.float32 = f32
        jax.config.update("jax_enable_x64", False)
    for s in seeds:
        r = runs[s]
        holds = all(np.all(np.abs(r["port32"][k] - r["jax32"][k])
                           <= 1e-3 * np.abs(r["jax32"][k])
                           + T.MOMENT_ATOL * np.abs(r["jax32"][k]).max())
                    for k in r["port64"] if k != "loss")
        worst = {}
        for k in r["port64"]:
            ref = np.abs(r["port64"][k]).max() if k != "loss" else 0
            if ref == 0:
                continue
            for a, b in PAIRS:
                d = np.abs(r[a][k] - r[b][k]).max() / ref
                if d >= worst.get((a, b), (-1,))[0]:
                    worst[(a, b)] = (d, k)
        print(f"seed {s}: gen_loss " + " ".join(
            f"{k} {r[k]['loss']!r}" for k in ("jax32", "port32", "jax64",
                                              "port64"))
              + f"; port32 at the test's limit of jax32: {holds}")
        for (a, b), (d, k) in worst.items():
            print(f"  |{a} - {b}| {d:.2e} ({k})")


if __name__ == "__main__":
    main([int(s) for s in (sys.argv[1] if len(sys.argv) > 1
                           else "0,1,2,3,4,5,6,7").split(",")],
         *sys.argv[2:3])
