"""The port's own copies of the JAX package's host-side modules (config,
image I/O, straightening, cropping) against the originals. (That the port
imports nothing of either package: test_torch_pipeline.py.)"""

import dataclasses

import numpy as np
import pytest

from autopanostitch_tpu import config as jconfig
from autopanostitch_tpu.models import crop as jcrop
from autopanostitch_tpu.models import straighten as jstraighten
from autopanostitch_tpu.utils import image_io as jio
from autopanostitch_tpu_torch import config as tconfig
from autopanostitch_tpu_torch import convert
from autopanostitch_tpu_torch.models import crop as tcrop
from autopanostitch_tpu_torch.models import straighten as tstraighten
from autopanostitch_tpu_torch.utils import image_io as tio
from test_torch_pipeline import one_torch_thread  # noqa: F401

CONFIG_CLASSES = sorted(n for n, v in vars(jconfig).items()
                        if isinstance(v, type) and dataclasses.is_dataclass(v))


def test_every_config_class_is_copied():
    assert len(CONFIG_CLASSES) == 11
    ported = sorted(n for n, v in vars(tconfig).items()
                    if isinstance(v, type) and dataclasses.is_dataclass(v))
    assert ported == CONFIG_CLASSES


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_config_defaults_equal_jax(name):
    jc, tc = getattr(jconfig, name)(), getattr(tconfig, name)()
    assert [f.name for f in dataclasses.fields(tc)] == [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.__dataclass_params__.frozen


def test_convert_config_round_trips_a_non_default_config():
    jc = jconfig.StitchConfig(
        detector=jconfig.DetectorConfig(max_keypoints=512, sigma=1.7),
        matching=jconfig.MatchingConfig(k=3),
        straighten=jconfig.StraightenConfig(force_planar_scan=True),
        blend=jconfig.BlendConfig(mode="linear"),
        render=jconfig.RenderConfig(projections=("spherical", "cylindrical"), tile=(64, 256)),
        tpu=jconfig.TPUConfig(match_block=512))
    tc = convert.config(jc)
    assert isinstance(tc, tconfig.StitchConfig)
    assert all(type(getattr(tc, f.name)).__module__ == tconfig.__name__
               for f in dataclasses.fields(tc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc != tconfig.StitchConfig() and tc.render.tile == (64, 256)
    assert convert.config(dataclasses.asdict(jc)) == tc
    assert convert.config(jconfig.StitchConfig()) == tconfig.default_config()


@pytest.mark.parametrize("seed", range(4))
def test_crop_matches_jax(seed):
    rng = np.random.default_rng(seed)
    mask = np.zeros((60, 90), bool)
    mask[rng.integers(0, 10):rng.integers(40, 60), rng.integers(0, 20):rng.integers(50, 90)] = True
    mask &= rng.random(mask.shape) > 0.002 * seed
    assert tcrop.largest_inscribed_rect(mask) == jcrop.largest_inscribed_rect(mask)
    pano = rng.integers(0, 255, (60, 90, 3)).astype(np.uint8) * mask[..., None]
    for name in ("crop_bbox", "crop_panorama"):
        (pt, rt), (pj, rj) = getattr(tcrop, name)(pano, mask), getattr(jcrop, name)(pano, mask)
        np.testing.assert_array_equal(pt, pj)
        assert rt == rj
    np.testing.assert_array_equal(tcrop.mask_from_color(pano), jcrop.mask_from_color(pano))


@pytest.mark.parametrize("yaw_only", [True, False])
def test_straighten_matches_jax(yaw_only):
    rng = np.random.default_rng(3)
    tilt = np.array([[1, 0, 0], [0, np.cos(0.2), -np.sin(0.2)], [0, np.sin(0.2), np.cos(0.2)]])
    Rs = []
    for k in range(8):
        a = k * 0.4
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        if not yaw_only:
            R = R @ tilt @ np.linalg.qr(np.eye(3) + 0.02 * rng.standard_normal((3, 3)))[0]
        Rs.append(R)
    Rs = np.stack(Rs).astype(np.float32)
    rt = tstraighten.straighten_rotations(Rs, tconfig.StraightenConfig())
    rj = jstraighten.straighten_rotations(Rs, jconfig.StraightenConfig())
    assert rt[1] == rj[1]
    np.testing.assert_array_equal(rt[0], rj[0])
    np.testing.assert_array_equal(rt[2], rj[2])


def test_image_io_matches_jax():
    rng = np.random.default_rng(5)
    views = [rng.random((h, w, 3)).astype(np.float32) for h, w in ((90, 120), (60, 200), (150, 80))]
    st = tio.image_set_from_arrays(views, height_limit=100, width_limit=100, keep_originals=True)
    sj = jio.image_set_from_arrays(views, height_limit=100, width_limit=100, keep_originals=True)
    assert isinstance(st, tio.ImageSet)
    np.testing.assert_array_equal(st.images, sj.images)
    np.testing.assert_array_equal(st.sizes, sj.sizes)
    assert st.names == sj.names
    for a, b in zip(st.originals, sj.originals):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tio.resize_fit(views[1], 50, 70), jio.resize_fit(views[1], 50, 70))
