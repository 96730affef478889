"""Analytic FLOP model of the SG-GAN nets and train steps, the port's
copy of ``sggan_tpu/utils/flops.py`` (held to it by
``tests/test_torch_tools.py``): pure Python, no framework.

Every conv is counted exactly (2*k*k*cin*cout per output element; a
transposed conv costs the same as the conv it is the gradient of);
elementwise and normalization FLOPs are left out (<1% of the total).
Each conv's backward is two convolutions of the same cost (the input
gradient and the weight gradient), so a layer on a gradient path costs
3x its forward in a train step.  ``chip_smoke.py`` divides a step's
FLOPs by its measured time and by the H100's dense bf16 peak for the
MFU of the graph's steps.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

N_RES_BLOCKS = 9


def conv_flops(out_h: int, out_w: int, k: int, cin: int, cout: int,
               batch: int = 1) -> float:
    return 2.0 * batch * out_h * out_w * k * k * cin * cout


def generator_resnet_fwd(h: int, w: int, ngf: int = 64, in_nc: int = 3,
                         out_nc: int = 3) -> List[Tuple[str, float]]:
    """Per-layer forward FLOPs (models/generator_resnet.py; reference
    module.py:219-269)."""
    layers = []
    layers.append(("c7s1", conv_flops(h, w, 7, in_nc, ngf)))
    layers.append(("d128", conv_flops(h // 2, w // 2, 3, ngf, ngf * 2)))
    layers.append(("d256", conv_flops(h // 4, w // 4, 3, ngf * 2, ngf * 4)))
    for i in range(N_RES_BLOCKS):
        layers.append((f"r{i + 1}",
                       2 * conv_flops(h // 4, w // 4, 3, ngf * 4, ngf * 4)))
    layers.append(("u128", conv_flops(h // 2, w // 2, 3, ngf * 4, ngf * 2)))
    layers.append(("u64", conv_flops(h, w, 3, ngf * 2, ngf)))
    layers.append(("out", conv_flops(h, w, 7, ngf, out_nc)))
    return layers


def discriminator_dims(h: int, w: int) -> List[Tuple[str, int, int]]:
    """Per-layer OUTPUT grid of the semantic discriminator (global head).

    Mirrors models/discriminator.py exactly: every conv is 3x3 (reference
    module.py:284-311): three stride-2 SAME convs, one stride-1 SAME conv,
    then the VALID tail (``_valid_chain``): stride-2 3x3 VALID
    ((n-3)//2+1) while the plane is > 3, and one final stride-1 3x3 VALID
    (n-2) if the plane is still >= 3.
    """
    dims = [("h0", h // 2, w // 2), ("h1", h // 4, w // 4),
            ("h2", h // 8, w // 8), ("h3", h // 8, w // 8)]
    hh, ww = h // 8, w // 8
    i = 0
    while min(hh, ww) > 3:
        hh, ww = (hh - 3) // 2 + 1, (ww - 3) // 2 + 1
        dims.append((f"v{i}", hh, ww))
        i += 1
    if min(hh, ww) >= 3:
        hh, ww = hh - 2, ww - 2
        dims.append((f"v{i}", hh, ww))
    dims.append(("h4", hh, ww))
    return dims


def discriminator_fwd(h: int, w: int, ndf: int = 64, in_nc: int = 3,
                      n_class: int = 34) -> List[Tuple[str, float]]:
    """Semantic discriminator, global head (models/discriminator.py;
    reference module.py:272-318).  All convs are k=3."""
    chans = {"h0": (in_nc, ndf), "h1": (ndf, ndf * 2),
             "h2": (ndf * 2, ndf * 4), "h3": (ndf * 4, ndf * 8),
             "h4": (ndf * 8, n_class)}
    layers = []
    for name, oh, ow in discriminator_dims(h, w):
        cin, cout = chans.get(name, (ndf * 8, ndf * 8))
        layers.append((name, conv_flops(oh, ow, 3, cin, cout)))
    return layers


def sggan_train_step(h: int, w: int, batch: int, ngf: int = 64,
                     ndf: int = 64, n_class: int = 34) -> Dict[str, float]:
    """Exact conv FLOPs of one sggan-mode train step at batch size
    `batch` (train/step.py): G fwd + G bwd (2x) through the gen loss; in
    the gen loss D runs fwd-only on the fake plus bwd-to-input (1x extra,
    no weight grads — D is frozen in the gen tape); the D loss runs D fwd
    on [real; fake] (2 samples/step) + full bwd (2x)."""
    g_fwd = sum(f for _, f in generator_resnet_fwd(h, w, ngf))
    d_fwd = sum(f for _, f in discriminator_fwd(h, w, ndf, n_class=n_class))
    per_img = (
        g_fwd * 3.0          # generator fwd + dgrad + wgrad
        + d_fwd * 2.0        # D(fake) in gen loss: fwd + input-grad only
        + d_fwd * 2.0 * 3.0  # D loss: fwd+bwd on real and pooled fake
    )
    return {
        "gen_fwd_flops": g_fwd,
        "disc_fwd_flops": d_fwd,
        "step_flops_per_image": per_img,
        "step_flops": per_img * batch,
    }


def cycle_train_step(h: int, w: int, batch: int, ngf: int = 64,
                     ndf: int = 64, n_class: int = 34,
                     identity: bool = True) -> Dict[str, float]:
    """Exact conv FLOPs of one cycle-mode train step (train/cycle.py;
    the north star's named objective, reference model.py:114-133).
    `batch` counts A/B PAIRS (each step consumes batch A-images AND
    batch B-images — the bench.py img/s convention divides by pairs).

    Gen tape: 6 generator applications (fake_b, fake_a, cyc_a, cyc_b,
    idt_b, idt_a — cycle.py:117-129), every one on a parameter gradient
    path, so each costs fwd + dgrad + wgrad = 3x; plus the two frozen-D
    forwards with input-grad only (2x each).  D tape: per domain, D on
    [real; pooled fake] (2 samples) fwd+bwd = 2*3x, two domains.

    Structural ratio vs sggan_train_step at the same (h, w):
    (18 g + 16 d) / (3 g + 8 d) ~= 6.0 at 256x512 — which is why the
    measured cycle pair/s is ~6x below the sggan img/s headline at the
    SAME achieved fraction of speed-of-light."""
    g_fwd = sum(f for _, f in generator_resnet_fwd(h, w, ngf))
    d_fwd = sum(f for _, f in discriminator_fwd(h, w, ndf, n_class=n_class))
    n_g = 6 if identity else 4
    per_pair = (
        g_fwd * n_g * 3.0    # all G applications: fwd + dgrad + wgrad
        + d_fwd * 2.0 * 2.0  # D(fake_a), D(fake_b) in gen tape: fwd+igrad
        + d_fwd * 4.0 * 3.0  # D tape: [real;fake] per domain, fwd+bwd
    )
    return {
        "gen_fwd_flops": g_fwd,
        "disc_fwd_flops": d_fwd,
        "step_flops_per_pair": per_pair,
        "step_flops": per_pair * batch,
        "vs_sggan_per_image": per_pair / sggan_train_step(
            h, w, 1, ngf, ndf, n_class)["step_flops_per_image"],
    }
