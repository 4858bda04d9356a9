"""The port's config module (tulip_tpu_torch.config) against the JAX
package's, of which it is a copy: every flag and default of the parser, the
static model configuration field by field, and model_config_from_args."""

import dataclasses

import pytest

from tulip_tpu import config as JC
from tulip_tpu_torch import config as TC

DURLAR = ["--model_select", "tulip_base", "--pixel_shuffle",
          "--circular_padding", "--patch_unmerging", "--log_transform",
          "--img_size_low_res", "32", "2048", "--img_size_high_res", "128",
          "2048", "--window_size", "2", "8", "--patch_size", "1", "4"]


def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_parser_has_the_same_flags():
    ours, ref = _actions(TC.get_args_parser()), _actions(JC.get_args_parser())
    assert set(ours) == set(ref)
    assert ({s for a in ours.values() for s in a.option_strings}
            == {s for a in ref.values() for s in a.option_strings})


@pytest.mark.parametrize("dest", sorted(_actions(JC.get_args_parser())))
def test_flag_matches(dest):
    a, b = _actions(TC.get_args_parser())[dest], _actions(JC.get_args_parser())[dest]
    for field in ("option_strings", "default", "type", "nargs", "choices",
                  "const", "required"):
        assert getattr(a, field) == getattr(b, field), (dest, field)
    assert type(a) is type(b)


def test_parsed_defaults_are_equal():
    ours = vars(TC.get_args_parser().parse_args(DURLAR))
    ref = vars(JC.get_args_parser().parse_args(DURLAR))
    assert ours == ref


def test_help_says_attn_impl_is_ignored_and_device_is_honoured():
    acts = _actions(TC.get_args_parser())
    assert "ignored" in acts["attn_impl"].help
    assert "cpu" in acts["device"].help and "raises" in acts["device"].help


@pytest.mark.parametrize("name,size", [("tulip_base", (32, 2048)),
                                       ("tulip_large", (32, 2048)),
                                       ("tulip_base", (16, 256)),
                                       ("tulip_base", (1, 1024))])
def test_model_config_equal_field_by_field(name, size):
    kw = dict(img_size=size, target_img_size=(size[0] * 4, size[1]),
              pixel_shuffle=True, circular_padding=True, log_transform=True,
              patch_unmerging=True, drop_path_rate=0.1)
    ours, ref = TC.model_config(name, **kw), JC.model_config(name, **kw)
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.num_layers == ref.num_layers
    assert ours.patch_grid == ref.patch_grid


def test_model_config_overrides_and_errors():
    kw = dict(img_size=(16, 256), target_img_size=(64, 256), depths=(2, 2),
              num_heads=(3, 6))
    assert dataclasses.asdict(TC.model_config("tulip_base", **kw)) == \
        dataclasses.asdict(JC.model_config("tulip_base", **kw))
    with pytest.raises(ValueError):
        TC.model_config("mae", (16, 256), (64, 256))


@pytest.mark.parametrize("grid,window,shifted", [
    ((32, 512), (2, 8), True), ((1, 64), (2, 8), True),
    ((1, 64), (2, 8), False), ((4, 64), (2, 8), False)])
def test_resolve_window_and_drop_path(grid, window, shifted):
    assert TC._resolve_window(grid, window, shifted) == \
        JC._resolve_window(grid, window, shifted)
    assert TC._drop_path_schedule((2, 2, 2, 2), 0.1) == \
        JC._drop_path_schedule((2, 2, 2, 2), 0.1)
    assert TC._drop_path_schedule((1,), 0.1) == JC._drop_path_schedule((1,), 0.1)


@pytest.mark.parametrize("attn_impl", ["xla", "grouped", "pallas"])
def test_model_config_from_args(attn_impl):
    """The same static config as the JAX package's from the same flags;
    --attn_impl is accepted and selects nothing (the JAX package turns
    'pallas' into 'grouped' on a CPU backend)."""
    argv = DURLAR + ["--attn_impl", attn_impl]
    ours = TC.model_config_from_args(TC.get_args_parser().parse_args(argv))
    ref = JC.model_config_from_args(JC.get_args_parser().parse_args(argv))
    a, b = dataclasses.asdict(ours), dataclasses.asdict(ref)
    assert a.pop("attn_impl") == attn_impl
    b.pop("attn_impl")
    assert a == b
