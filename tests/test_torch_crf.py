"""The dense CRF of the port (``metrics/crf.py``) and ``--eval_crf`` on
the CPU, held to the JAX package's:

* the library built from ``native/crf/*.cpp`` into
  ``sggan_tpu_torch/_build/`` against the JAX copy's ``dense_crf`` and
  lattice filter (atol 1e-5), against the numpy mean field at 12x12 and
  16x16 (argmax agreeing on > 90% of pixels, tests/test_crf.py's limit:
  the lattice is an approximation), the scoring adapters equal; a build
  that fails raises with the compiler's output;
* ``--eval_crf``: the port's epoch-end eval against the JAX eval's
  ``test_during_train`` fed the same fakes (the port generator's, at the
  source size, so both preprocesses are exact): the refined scores
  equal."""

import os
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sggan_tpu.config import Config as JConfig  # noqa: E402
from sggan_tpu.metrics import crf as jcrf  # noqa: E402
from sggan_tpu.train import evaluate as jeval  # noqa: E402
from sggan_tpu_torch.metrics import crf as tcrf  # noqa: E402
from sggan_tpu_torch.ops import _build  # noqa: E402
from sggan_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_trainer import _cfg, dataset  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _probs(rng, c, h, w):
    p = rng.dirichlet(np.ones(c) * 2.0, (h, w)).astype(np.float32)
    return np.ascontiguousarray(p.transpose(2, 0, 1))


def test_crf_library_is_built_from_the_sources():
    lib = tcrf._lib()
    path = _build.BUILD_DIR / os.path.basename(lib._name)
    assert path.parent == _build.BUILD_DIR and path.is_file()
    assert path.name.startswith("libsgcrf-")
    assert os.path.samefile(tcrf.native_dir(), os.path.join(ROOT, "native",
                                                            "crf"))


@pytest.mark.parametrize("c,h,w,with_img", [(3, 24, 32, True),
                                            (8, 17, 13, True),
                                            (4, 16, 16, False)])
def test_dense_crf_matches_the_jax_copy(c, h, w, with_img):
    rng = np.random.default_rng(c)
    probs = _probs(rng, c, h, w)
    img = rng.integers(0, 255, (h, w, 3), np.uint8) if with_img else None
    got = tcrf.dense_crf(img, probs)
    assert got.shape == (c, h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, jcrf.dense_crf(img, probs), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got.sum(0), 1.0, atol=1e-4)
    feats = rng.uniform(0, 6, (300, 2)).astype(np.float32)
    vals = rng.normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_allclose(tcrf.permutohedral_filter(feats, vals),
                               jcrf.permutohedral_filter(feats, vals),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [12, 16])
def test_dense_crf_agrees_with_the_numpy_mean_field(hw):
    rng = np.random.default_rng(2)
    probs = _probs(rng, 3, hw, hw)
    img = rng.integers(0, 255, (hw, hw, 3), np.uint8)
    unary = tcrf.unary_from_softmax(probs)
    np.testing.assert_array_equal(unary, jcrf.unary_from_softmax(probs))
    u_hwc = np.ascontiguousarray(unary.transpose(1, 2, 0))
    q_np = tcrf._mean_field_numpy(u_hwc, img, tcrf.MAX_ITER)
    np.testing.assert_array_equal(
        q_np, jcrf._mean_field_numpy(u_hwc, img, jcrf.MAX_ITER))
    agree = (tcrf.dense_crf(img, probs).argmax(0)
             == q_np.transpose(2, 0, 1).argmax(0)).mean()
    assert agree > 0.9, agree


def test_crf_scoring_adapters_match_jax():
    rng = np.random.default_rng(3)
    sample = rng.uniform(0, 255, (1, 16, 16, 3))
    mask = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (1, 16, 16))]
    fake = rng.uniform(size=(1, 16, 16, 3)).astype(np.float32)
    da = rng.uniform(size=(1, 2, 2, 1)).astype(np.float32)
    for name, args in (("scores_mask_sample_crf", (mask, sample)),
                       ("scores_fake_mask_crf", (mask, sample, fake)),
                       ("scores_mask_fake_crf", (sample, mask, fake)),
                       ("scores_seg_da_fake", (fake, da))):
        got = getattr(tcrf, name)(*args)
        ref = getattr(jcrf, name)(*args)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_a_failed_crf_build_raises(tmp_path, monkeypatch):
    for f in tcrf.NATIVE_FILES:
        (tmp_path / f).write_text("this is not C++\n")
    monkeypatch.setattr(tcrf, "native_dir", lambda: tmp_path)
    tcrf._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="failed on"):
            tcrf.dense_crf(None, np.full((2, 4, 4), 0.5, np.float32))
    finally:
        tcrf._lib.cache_clear()
    assert not list(tmp_path.glob("*.so"))


def test_eval_crf_matches_the_jax_eval(dataset, tmp_path):
    """--eval_crf through the trainer: the scores of the port's eval equal
    the JAX eval's, fed the same fakes; the refinement changes them."""
    cfg = _cfg(dataset, tmp_path, image_height=64, image_width=64,
               eval_crf=True)
    tr = Trainer(cfg, device="cpu")
    fakes, score = tr.test_during_train(0)
    plain = Trainer(cfg.replace(eval_crf=False),
                    device="cpu").test_during_train(0)[1]
    jtr = types.SimpleNamespace(
        cfg=JConfig(**{k: getattr(cfg, k) for k in (
            "dataset_dir", "image_height", "image_width", "segment_class",
            "eval_crf", "test_dir", "decode_cache_mb")}),
        is_coord=True, root=tr.root, max_src_hw=tr.max_src_hw,
        _eval_seg_cache={}, generate=lambda img, as_u8: fakes)
    jfakes, jscore = jeval.test_during_train(jtr, 0)
    np.testing.assert_array_equal(jfakes, fakes)
    assert _values(score) == _values(jscore)  # nan == nan here
    assert _values(score) != _values(plain)


def _values(score: dict) -> dict:
    """A score dict with the per-class dict flattened, each value a
    string: equal strings, equal floats (NaNs included)."""
    out = {}
    for k, v in score.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[k, kk] = repr(float(vv))
    return out
