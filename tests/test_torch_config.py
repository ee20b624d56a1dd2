"""The port's own configuration classes against ``dvo_tpu.config``'s: the
same fields, defaults and presets, field by field, and
``config_from_reference`` converting one package's object into the other's
values.  Tolerance 0: the values are Python numbers, strings and tuples."""

import dataclasses

import pytest

from dvo_tpu import config as jconfig
from dvo_tpu_torch import config as tconfig

CLASSES = ["PyramidConfig", "TrackerConfig", "DepthFilterConfig", "MapperConfig", "InitConfig",
           "BAConfig", "DVOConfig"]
PRESETS = {
    "default": lambda m: m.DVOConfig(),
    "monocular": lambda m: m.DVOConfig.monocular(),
    "rgbd": lambda m: m.DVOConfig.rgbd(),
    "edited": lambda m: dataclasses.replace(
        m.DVOConfig.rgbd(),
        pyramid=m.PyramidConfig(levels=2, culls=0),
        tracker=m.TrackerConfig(level_steps=(3.0, 1.0), crop_x=(1, 9), compat_weight_b_only=True),
        mapper=m.MapperConfig(accept_sigma=(0.0, 2.0),
                              depth_filter=m.DepthFilterConfig(reset_depth_range=(0.25, 1.0))),
        ba=m.BAConfig(enabled=True, window=3)),
}


def _assert_same_values(port, ref):
    """Field by field, nested dataclasses walked; the classes differ."""
    assert type(port).__name__ == type(ref).__name__
    assert type(port).__module__ == "dvo_tpu_torch.config"
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            _assert_same_values(a, b)
        else:
            assert type(a) is type(b) and a == b, (type(ref).__name__, f.name, a, b)


@pytest.mark.parametrize("name", CLASSES)
def test_class_has_the_reference_fields_and_defaults(name):
    port, ref = getattr(tconfig, name), getattr(jconfig, name)
    assert port is not ref and dataclasses.is_dataclass(port)
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref)]
    _assert_same_values(port(), ref())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(port(), dataclasses.fields(port)[0].name, 0)


@pytest.mark.parametrize("preset", list(PRESETS))
def test_preset_equals_the_reference(preset):
    _assert_same_values(PRESETS[preset](tconfig), PRESETS[preset](jconfig))


@pytest.mark.parametrize("preset", list(PRESETS))
def test_config_from_reference_round_trips(preset):
    ref = PRESETS[preset](jconfig)
    port = tconfig.config_from_reference(ref)
    _assert_same_values(port, ref)
    assert port == PRESETS[preset](tconfig) and hash(port) == hash(PRESETS[preset](tconfig))
    # the port's own object converts to itself, and a part converts alone
    assert tconfig.config_from_reference(port) == port
    _assert_same_values(tconfig.config_from_reference(ref.tracker), ref.tracker)
    _assert_same_values(tconfig.config_from_reference(ref.mapper.depth_filter),
                        ref.mapper.depth_filter)


def test_config_from_reference_rejects_other_objects():
    @dataclasses.dataclass(frozen=True)
    class TrackerConfig:   # the right name, the wrong fields
        max_iterations: int = 3

    with pytest.raises(ValueError, match="fields differ"):
        tconfig.config_from_reference(TrackerConfig())
    with pytest.raises(TypeError):
        tconfig.config_from_reference({"levels": 3})


def test_constants_equal_the_reference():
    assert tconfig.EPSILON == jconfig.EPSILON and tconfig.INVALID == jconfig.INVALID
    assert not hasattr(tconfig, "resolve_backend")
