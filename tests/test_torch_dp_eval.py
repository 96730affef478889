"""The coordinator's eval under ``--mesh_data 2`` may outlast the
collectives' timeout (``--eval_crf`` refines each fake on one host thread
over the whole test split), and the other ranks wait it out, as the JAX
processes do: ``sggan_tpu_torch.main`` trains one epoch over two gloo
ranks (``tests/_torch_dp_worker.py slow_eval``) that joined the process
group with a timeout of ``TIMEOUT_S``, while the coordinator's eval takes
``EVAL_S`` longer.  Rank 1 waits at the barrier of ``dp.wait_group``,
whose timeout is its own, and both ranks then save and finish."""

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import run_ranks, write_dataset  # noqa: E402

TIMEOUT_S, EVAL_S = 10, 25


def test_ranks_wait_out_an_eval_longer_than_the_timeout(tmp_path):
    assert EVAL_S > 2 * TIMEOUT_S
    root = tmp_path / "datasets" / "city"
    write_dataset(root, 4, 2)
    outs = run_ranks("slow_eval", [root, tmp_path / "work", TIMEOUT_S,
                                   EVAL_S])
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, f"rank {r} failed:\n{out}"
        line = next(x for x in out.splitlines()
                    if x.startswith(f"OK slow eval rank {r} trained in "))
        assert float(line.split()[-2]) >= EVAL_S, line
        assert "OK imported no JAX module: True" in out, out
