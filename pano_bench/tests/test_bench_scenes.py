"""The scene generators against `tests/synthdata.py` and `chip_smoke.py`
(the arithmetic they were copied from) at a small size."""

import sys

import numpy as np
import pytest
import torch

from pano_bench import scenes
from pano_bench.scenes import synth
from pano_bench.tests.conftest import ROOT

sys.path.insert(0, str(ROOT / "tests"))
import synthdata  # noqa: E402


def test_textures_equal_synthdata():
    assert np.array_equal(synth.texture(5, 90, 120), synthdata.texture(5, 90, 120))
    got = synth.smooth_texture(7, 64, 128, 0.08).numpy()
    assert np.abs(got - synthdata.smooth_texture(7, 64, 128, 0.08)).max() < 1e-6


def test_pinhole_view_equals_synthdata():
    env = synthdata.smooth_texture(3, 128, 256)
    R = synthdata.rot_y(0.7).T
    want = synthdata.render_pinhole_from_equirect(env, R, 60.0, 80, 60, "bicubic")
    got = synth.render_pinhole(torch.as_tensor(env), R[None], 60.0, 80, 60)[0].numpy()
    assert np.abs(got - want).max() < 1e-5
    x, y = np.array([[0.3, 17.9], [120.0, 5.5]]), np.array([[2.2, 60.1], [0.0, 99.9]])
    assert np.abs(synth.bilinear(torch.as_tensor(env), torch.as_tensor(x), torch.as_tensor(y))
                  .numpy() - synthdata._bilinear_np(env, x, y)).max() < 1e-6


@pytest.mark.parametrize("ingest", [None, 48])
def test_ring_folder_equals_synthdata(ingest):
    traffic = {"kind": "rings", "pool": 2, "content_seed": 2**40 + 3, "views": 6, "rings": 2, "distractors": 1,
               "distractor_pitch": 0.4, "width": 80, "height": 60, "focal_px": 60.0,
               "env": [64, 128], "cutoff": 0.08, "ingest_limit": ingest}
    f = scenes.make(traffic, 5, 1, torch.device("cpu"))
    rng = scenes.folder_rng(2**40 + 3, 1)
    tex = rng.integers(0, 2**31, size=3)
    yaw0 = rng.uniform(0.0, 2 * np.pi / 6, size=2)
    assert f.stitch_seed == int(scenes.folder_rng(5, 1).integers(0, 2**31))
    views = [None] * 12
    for r in range(2):
        env = synthdata.smooth_texture(int(tex[r]), 64, 128)
        for i in range(6):
            R = synthdata.rot_y(yaw0[r] + i * 2 * np.pi / 6).T
            views[2 * i + r] = synthdata.render_pinhole_from_equirect(env, R, 60.0, 80, 60,
                                                                       "bicubic")
        assert np.array_equal(f.truth["rings"][r]["members"], np.arange(r, 12, 2))
    env_c = synthdata.smooth_texture(int(tex[2]), 64, 128)
    views.append(synthdata.render_pinhole_from_equirect(env_c, synthdata.rot_x(0.4).T, 60.0,
                                                        80, 60, "bicubic"))
    if ingest is None:
        want = (np.stack(views) * 255).astype(np.uint8)
        diff = np.abs(f.iset.images.astype(int) - want.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3  # truncation at a level's edge
    else:
        from autopanostitch_tpu_torch.api import image_set_from_arrays

        want = image_set_from_arrays(views, height_limit=ingest, width_limit=ingest,
                                     keep_originals=True)
        assert f.iset.images.shape == want.images.shape
        diff = np.abs(f.iset.images.astype(np.float64) - want.images.astype(np.float64))
        assert diff.max() <= 1  # a level apart where a view's value sits at a level's edge
        assert len(f.iset.originals) == 13


def test_planar_folder_equals_chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    traffic = {"kind": "planar", "pool": 1, "content_seed": 9, "rows": 3, "cols": 3,
               "width": 80, "height": 60, "overlap": 0.35}
    f = scenes.make(traffic, 4, 0, torch.device("cpu"))
    tex = int(scenes.folder_rng(9, 0).integers(0, 2**31))
    iset, env, offs = chip_smoke.planar_scene(80, 60, 0.35, seed=tex)
    assert np.array_equal(f.iset.images, iset.images)
    assert np.array_equal(f.truth["offsets"], offs)
    assert np.array_equal(f.truth["env"].numpy(), env)


def test_seeds_draw_stitch_seeds_over_fixed_content():
    traffic = {"kind": "planar", "pool": 2, "content_seed": 1, "rows": 3, "cols": 3,
               "width": 40, "height": 30, "overlap": 0.35}
    a = scenes.make(traffic, 2**35 + 123, 0, torch.device("cpu"))
    b = scenes.make(traffic, 2**35 + 123, 0, torch.device("cpu"))
    c = scenes.make(traffic, 2**35 + 124, 0, torch.device("cpu"))
    d = scenes.make(traffic, 2**35 + 123, 1, torch.device("cpu"))
    assert np.array_equal(a.iset.images, b.iset.images) and a.stitch_seed == b.stitch_seed
    assert np.array_equal(a.iset.images, c.iset.images) and a.stitch_seed != c.stitch_seed
    assert not np.array_equal(a.iset.images, d.iset.images)
