"""Cycle reconstruction and identity scores of a trained two-domain run
(``--loss_mode cycle``), the port of the root ``cycle_recon_eval.py``.

It loads the run's latest ``cp-NNNN.pt`` (the EMA shadow of both
generators when the run kept one, as every eval and serving path), then
reports the training objective's own L1 terms, with the JAX script's
convention (inputs in [0, 1], the generators' tanh outputs in [-1, 1]):

    A side (the run's testA):  cyc_a = |G_ba(G_ab(a)) - a|,
                               idt_a = |G_ba(a) - a|
    B side (``b_dir``):        cyc_b = |G_ab(G_ba(b)) - b|,
                               idt_b = |G_ab(b) - b|

and writes the strips (a, G_ab(a), recon a) and (b, G_ba(b), recon b) as
PNGs under ``<run>/recon/``.

    python -m sggan_tpu_torch.cycle_recon_eval <run_dir> [b_dir] \\
        [key=value ...]

``key=value`` pairs override the config (``use_resnet=true``,
``image_height=256``, ...), whose defaults are the JAX script's (cycle,
128x128, bf16).  ``b_dir`` is by default the dataset's ``testB``.  It
runs on the card; ``main(argv, device="cpu")`` is for tests.
"""

from __future__ import annotations

import copy
import json
import os
import sys
from typing import Dict

import numpy as np
import torch
from PIL import Image

from .config import Config
from .data.preprocess import preprocess_test
from .train import evaluate
from .train.trainer import Trainer
from .utils import checkpoint as ckpt


def _parse_override(v: str):
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def load_dir(cfg: Config, d: str, device) -> torch.Tensor:
    """Every image of ``d`` (sorted, the first three channels) resized to
    the config's size: (N, H, W, 3) f32 in [0, 1] on ``device``."""
    ims = [np.asarray(Image.open(os.path.join(d, f)))[..., :3]
           for f in sorted(os.listdir(d))]
    x = torch.from_numpy(np.stack(ims).astype(np.uint8)).to(device)
    img, _, _, _ = preprocess_test(x, x, None, out_hw=cfg.image_size,
                                   mask_hw=cfg.mask_hw,
                                   n_class=cfg.segment_class,
                                   with_masks=False)
    return img


@torch.inference_mode()
def recon_scores(cfg: Config, gens: Dict[str, torch.nn.Module],
                 a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The four L1 scores of the generators ``gens`` {"a2b", "b2a"} on
    ``a`` and ``b`` ((N, H, W, 3) in [0, 1]), and the outputs
    (fake_b, cyc_a, fake_a, cyc_b), f32."""
    def g(which, x):
        return evaluate.gen_forward(cfg, gens[which], x).float()

    def l1(x, y):
        return float((x - y).abs().mean())

    fake_b = g("a2b", a)
    cyc_a = g("b2a", fake_b)
    idt_a = g("b2a", a)
    fake_a = g("b2a", b)
    cyc_b = g("a2b", fake_a)
    idt_b = g("a2b", b)
    rec = {"n_a": int(a.shape[0]), "n_b": int(b.shape[0]),
           "cyc_a_l1": l1(cyc_a, a), "idt_a_l1": l1(idt_a, a),
           "cyc_b_l1": l1(cyc_b, b), "idt_b_l1": l1(idt_b, b)}
    return rec, (fake_b, cyc_a, fake_a, cyc_b)


def eval_generators(state) -> Dict[str, torch.nn.Module]:
    """Both generators of a cycle state; under ``--gen_ema`` copies that
    hold the EMA shadow."""
    gens = state.gen_params
    if state.ema is None:
        return {k: gens[k] for k in ("a2b", "b2a")}
    gens = copy.deepcopy(gens).requires_grad_(False)
    with torch.no_grad():
        for k, p in gens.named_parameters():
            p.copy_(state.ema[k])
    return {k: gens[k] for k in ("a2b", "b2a")}


def _strip(path: str, *imgs) -> None:
    row = []
    for im in imgs:
        v = im.detach().cpu().numpy()
        if v.min() < -0.01:  # a tanh output
            v = (v + 1.0) / 2.0
        row.append(np.clip(v, 0, 1))
    strip = (np.concatenate(row, axis=1) * 255).astype(np.uint8)
    Image.fromarray(strip).save(path)


def main(argv=None, device="cuda") -> dict:
    argv = sys.argv[1:] if argv is None else argv
    run = argv[0]
    b_dir = argv[1] if len(argv) > 1 and "=" not in argv[1] else None
    overrides = dict((k, _parse_override(v)) for k, v in
                     (a.split("=", 1) for a in argv[1:] if "=" in a))
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("sggan_tpu_torch.cycle_recon_eval: no CUDA device "
                         "is visible")
    if b_dir is not None:
        b_dir = os.path.abspath(b_dir)
    os.chdir(run)
    cfg = Config(loss_mode="cycle", batch_size=1, image_height=128,
                 image_width=128, compute_dtype="bfloat16",
                 decode_cache_mb=8192).replace(**overrides).validate()
    tr = Trainer(cfg, device=device)
    restored = ckpt.load(tr.state, cfg.checkpoint_dir, cfg.dataset_dir,
                         pool=False)
    if restored is None:
        raise SystemExit(f"no checkpoint under {cfg.checkpoint_dir}")
    tr.state = restored
    a = load_dir(cfg, os.path.join(tr.root, "testA"), tr.device)
    b = load_dir(cfg, b_dir or os.path.join(tr.root, "testB"), tr.device)
    rec, (fake_b, cyc_a, fake_a, cyc_b) = recon_scores(
        cfg, eval_generators(tr.state), a, b)
    print("RECON " + json.dumps({k: round(v, 4) if isinstance(v, float)
                                 else v for k, v in rec.items()}),
          flush=True)
    os.makedirs("recon", exist_ok=True)
    _strip(os.path.join("recon", "a_fake_recon.png"), a[0], fake_b[0],
           cyc_a[0])
    _strip(os.path.join("recon", "b_fake_recon.png"), b[0], fake_a[0],
           cyc_b[0])
    print("samples: recon/a_fake_recon.png recon/b_fake_recon.png")
    return rec


if __name__ == "__main__":
    main()
