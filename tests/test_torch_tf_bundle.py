"""The port's copy of ``tf_bundle`` (``sggan_tpu_torch/utils/tf_bundle.py``,
the TensorBundle reader and writer of the TF import) on the CPU: it
passes ``tests/test_tf_bundle.py``'s own cases with the copy in place of
the original, and writes the same bytes as the original (split from
``tests/test_torch_tf_import.py``, which holds the import)."""

import inspect
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import test_tf_bundle as bundle_cases  # noqa: E402
from sggan_tpu.utils import tf_bundle as jbundle  # noqa: E402
from sggan_tpu_torch.utils import tf_bundle as tbundle  # noqa: E402

BUNDLE_CASES = [name for name, fn in vars(bundle_cases).items()
                if name.startswith("test_") and callable(fn)
                and name != "test_import_selftest"]  # the JAX import's


@pytest.mark.parametrize("case", BUNDLE_CASES)
def test_tf_bundle_copy_passes_the_originals_case(case, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(bundle_cases, "tf_bundle", tbundle)
    fn = getattr(bundle_cases, case)
    fn(*([tmp_path] if inspect.signature(fn).parameters else []))


def test_tf_bundle_copy_writes_the_originals_bytes(tmp_path):
    tensors = bundle_cases._random_tensors(np.random.default_rng(11), 25)
    for compress in (False, True):
        files = []
        for i, mod in enumerate((jbundle, tbundle)):
            prefix = str(tmp_path / f"{compress}{i}" / "cp-0000.ckpt")
            os.makedirs(os.path.dirname(prefix))
            mod.write_bundle(prefix, tensors, compress=compress,
                             block_size=200, restart_interval=2)
            files.append([open(prefix + s, "rb").read() for s in
                          (".index", ".data-00000-of-00001")])
        assert files[0] == files[1]
