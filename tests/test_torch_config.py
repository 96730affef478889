"""The port's own Config and CLI against the JAX package's: the same
fields, types and defaults, the same flags, the same validation."""

import dataclasses

import pytest

pytest.importorskip("torch")

from sggan_tpu import config as jcfg  # noqa: E402
from sggan_tpu_torch import config as tcfg  # noqa: E402


def test_config_fields_types_and_defaults_match():
    def spec(cls):
        return [(f.name, str(f.type), f.default)
                for f in dataclasses.fields(cls)]
    assert spec(tcfg.Config) == spec(jcfg.Config)
    assert tcfg.Config().mask_hw == jcfg.Config().mask_hw
    assert tcfg.Config(image_height=256, image_width=512).image_size \
        == (256, 512)


def test_parser_flags_and_defaults_match():
    def flags(p):
        return sorted((tuple(a.option_strings), a.dest, a.default,
                       a.choices and tuple(a.choices))
                      for a in p._actions)
    assert flags(tcfg.build_parser()) == flags(jcfg.build_parser())
    argv = ["--loss_mode", "sggan", "--use_resnet", "--img_height", "256",
            "--max_size", "0", "--no-use_augmentation", "--gen_ema", "0.99"]
    got, ref = tcfg.parse_args(argv), jcfg.parse_args(argv)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert isinstance(got, tcfg.Config)


@pytest.mark.parametrize("kw", [dict(image_height=100),
                                dict(loss_mode="bogus"),
                                dict(sggan_l1_target="x"),
                                dict(gen_ema=1.5), dict(scan_steps=0)])
def test_validate_refuses_what_the_jax_config_refuses(kw):
    with pytest.raises(ValueError) as ref:
        jcfg.Config(**kw).validate()
    with pytest.raises(ValueError) as got:
        tcfg.Config(**kw).validate()
    assert str(got.value) == str(ref.value)
