"""The port's config copy against plo_tpu.config: Config() and the shipped
presets field for field, and convert.config_from_dict on both."""
import dataclasses
import glob
import os

import pytest

from plo_tpu import config as jax_cfg
from plo_tpu_torch import config as port_cfg
from plo_tpu_torch.convert import config_from_dict

PRESETS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.json")))


def test_presets_found():
    assert len(PRESETS) == 4


@pytest.mark.parametrize("path", [None] + PRESETS,
                         ids=["Config()"] + [os.path.basename(p) for p in PRESETS])
def test_config_matches_jax_field_for_field(path):
    if path is None:
        a, b = jax_cfg.Config(), port_cfg.Config()
    else:
        a, b = jax_cfg.load(path), port_cfg.load(path)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.grid_width == b.grid_width
    # The converted config is the port's own, equal to the loaded one.
    conv = config_from_dict(dataclasses.asdict(a))
    assert isinstance(conv, port_cfg.Config)
    assert conv == b


def test_config_from_dict_rejects_unknown_keys():
    tree = dataclasses.asdict(jax_cfg.Config())
    tree["laser_odometry"]["no_such_key"] = 1
    with pytest.raises(ValueError, match="no_such_key"):
        config_from_dict(tree)
