"""Port parity of the image pool: ``sggan_tpu_torch.train.pool`` against
``sggan_tpu.train.pool.pool_update`` on the same items, with the random
draws taken from the JAX key the way ``pool_update`` takes them (per item
i: ``split(fold_in(key, i))`` into the p = 0.5 uniform and the slot)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sggan_tpu.train import pool as jpool  # noqa: E402
from sggan_tpu_torch.train import pool as tpool  # noqa: E402

SHAPES = {"fake": (4, 6, 3), "mask": (2, 3, 5)}
# XLA's LLVM passes spend seconds on the threefry code of each program;
# the pool's decisions are integer and select work, unchanged without them
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def _run(fn, *args):
    return jax.jit(fn).lower(*args).compile(FAST)(*args)


def _draws(keys, b, max_size):
    """The draws ``pool_update`` takes from each of ``keys``, as one
    program."""
    def one(key, i):
        k_use, k_idx = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.uniform(k_use),
                jax.random.randint(k_idx, (), 0, max_size))
    u, idx = _run(lambda ks: jax.vmap(lambda k: jax.vmap(
        lambda i: one(k, i))(jnp.arange(b)))(ks), jnp.stack(keys))
    return [tpool.PoolDraws(torch.from_numpy(np.array(a)),
                            torch.from_numpy(np.array(c)).long())
            for a, c in zip(u, idx)]


def _items(b, seed):
    r = np.random.default_rng(seed)
    return {"fake": r.standard_normal((b, *SHAPES["fake"]))
            .astype(np.float32),
            "mask": np.eye(5, dtype=np.float32)[
                r.integers(0, 5, (b, *SHAPES["mask"][:2]))]}


def _to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_pool_update_matches_jax_fill_then_swap():
    """max_size 2, batch 2: the first update fills, the next ones swap;
    pairs stay together and the count stops at max_size."""
    jstate = jpool.pool_init(2, SHAPES)
    tstate = tpool.pool_init(2, SHAPES, device="cpu")
    keys = [jax.random.PRNGKey(s) for s in (3, 11, 12, 13)]
    update = jax.jit(jpool.pool_update).lower(jstate, keys[0], _items(2, 0)) \
        .compile(FAST)
    swapped = 0
    for step, (key, draws) in enumerate(zip(keys, _draws(keys, 2, 2))):
        items = _items(2, step)
        jstate, jout = update(jstate, key, items)
        tstate, tout = tpool.pool_update(tstate, _to_torch(items), draws)
        assert tstate.count == int(jstate.count) == 2
        for k in SHAPES:
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]))
            np.testing.assert_array_equal(tstate.buffer[k].numpy(),
                                          np.asarray(jstate.buffer[k]))
        # a pair stays a pair: each output fake comes with its own mask
        seen = {tuple(np.round(f.ravel()[:3], 5)): m for f, m in
                zip(np.concatenate([tstate.buffer["fake"], tout["fake"]]),
                    np.concatenate([tstate.buffer["mask"], tout["mask"]]))}
        for f, m in zip(tout["fake"].numpy(), tout["mask"].numpy()):
            np.testing.assert_array_equal(seen[tuple(np.round(
                f.ravel()[:3], 5))], m)
        swapped += sum(not np.array_equal(tout["fake"][i].numpy(),
                                          items["fake"][i])
                       for i in range(2))
    assert swapped > 0  # the draws did take history


def test_pool_fills_in_order_and_passes_items_through():
    state = tpool.pool_init(3, SHAPES, device="cpu")
    items = _to_torch(_items(2, 0))
    draws = tpool.pool_draws(torch.Generator().manual_seed(0), 2, 3)
    state, out = tpool.pool_update(state, items, draws)
    assert state.count == 2
    for k in SHAPES:
        assert torch.equal(out[k], items[k])
        assert torch.equal(state.buffer[k][:2], items[k])
        assert not state.buffer[k][2].any()


def test_pool_of_max_size_zero_keeps_one_slot():
    """max_size 0 disables the pool in the step; the state still has the
    JAX package's one-slot buffer, and an update passes the first item."""
    jstate = jpool.pool_init(0, SHAPES)
    tstate = tpool.pool_init(0, SHAPES, device="cpu")
    assert tstate.buffer["fake"].shape == jstate.buffer["fake"].shape \
        == (1, *SHAPES["fake"])
    items = _to_torch(_items(1, 0))
    tstate, out = tpool.pool_update(
        tstate, items, tpool.pool_draws(torch.Generator(), 1, 0))
    assert tstate.count == 1 and torch.equal(out["fake"], items["fake"])


def test_bf16_storage_casts_items_on_entry():
    state = tpool.pool_init(2, SHAPES, dtype=torch.bfloat16, device="cpu")
    items = _to_torch(_items(2, 1))
    state, out = tpool.pool_update(
        state, items, tpool.pool_draws(torch.Generator(), 2, 2))
    assert out["fake"].dtype == state.buffer["fake"].dtype == torch.bfloat16
    assert torch.equal(out["fake"], items["fake"].bfloat16())
    assert torch.equal(out["mask"].float(), items["mask"])  # one-hot exact
