"""The port's copy of config.py parses the demo .ini files as the JAX package does.

Tolerance: none; every option field, the camera included, must be equal.
"""

import dataclasses
import glob
import os

import pytest

from srba_slam_tpu.config import load_config as jload
from srba_slam_tpu_torch.config import load_config

DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo")


@pytest.mark.parametrize("ini", sorted(glob.glob(os.path.join(DEMO, "*.ini"))),
                         ids=os.path.basename)
def test_demo_config_parses_equal(ini):
    for ref, got in zip(jload(ini), load_config(ini)):
        assert type(ref).__name__ == type(got).__name__
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
