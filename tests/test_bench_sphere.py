"""The benchmark's full sphere (`pano_bench/scenes/sphere.py`, the
`equirect800` configuration, the `render_slot_share` reader): the rig of
`sphere102` row by row, a texture as fine at the poles as at the equator,
a small full sphere stitched through `harness.run_cell` on the CPU to a
correct, whole equirectangular canvas, and the configuration pinned as
`rot800` with only the render projection changed."""

import copy
import io
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pano_bench import harness, scenes, spans, spec
from pano_bench.scenes import sphere, synth

BENCH = spec.load_benchmark()
CELL = "equirect800.sphere102"

# A sphere small enough for the CPU (the port runs its plain kernel
# versions there): 16 views of 320x240 at f = 150 px (93 x 77 degrees) in
# rows at pitch 0 (6), +-50 (4) and the zenith and nadir, about a third
# overlapping. Sound runs read the same at seeds 2**33 + 5, 7 and 2**40 + 1
# (the content is fixed): focal 0.538 %, rotations 0.085 deg, 47.20 dB, no
# match off the rule; the limits leave room beyond those.
SMALL = {"rows": [[0, 6], [50, 4], [-50, 4], [90, 1], [-90, 1]], "width": 320, "height": 240,
         "focal_px": 150.0, "env": [192, 384], "period_px": 18.0, "pool": 1}
LIMITS = {"members_wrong": {"limit": 0, "better": "lower"},
          "focal_err_pct": {"limit": 1.0, "better": "lower"},
          "rot_err_deg": {"limit": 0.2, "better": "lower"},
          "psnr_db": {"limit": 44.0, "better": "higher"},
          "match_excess": {"limit": 1e-4, "better": "lower"},
          "match_missing": {"limit": 1e-4, "better": "lower"}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pitch_yaw(R):
    """Each view's pitch (degrees, up positive) and yaw (radians) from its
    world -> camera rotation: the optical axis is the third row."""
    fwd = R[:, 2, :]
    return np.degrees(np.arcsin(-fwd[:, 1])), np.arctan2(fwd[:, 0], fwd[:, 2])


def test_rig_rows():
    """sphere102 is 102 views in rows of the stated pitches, each row evenly
    spaced in yaw, every camera level (its x axis horizontal)."""
    traffic = spec.traffic("sphere102")
    traffic.update(width=40, height=30, env=[16, 32])
    folder = scenes.make(traffic, 2**40 + 9, 3, torch.device("cpu"))
    R = folder.truth["rings"][0]["R"]
    assert folder.truth["views"] == 102 == len(R) == folder.iset.images.shape[0]
    assert sorted(folder.truth["rings"][0]["members"]) == list(range(102))
    want = [(0, 16), (18, 15), (-18, 15), (36, 13), (-36, 13), (54, 9), (-54, 9), (72, 5),
            (-72, 5), (90, 1), (-90, 1)]
    assert [tuple(r) for r in traffic["rows"]] == want
    pitch, yaw = _pitch_yaw(R)
    assert np.abs(R[:, 0, 1]).max() < 1e-12  # roll 0
    k = 0
    for p, n in want:
        assert np.abs(pitch[k:k + n] - p).max() < 1e-9
        if n > 1 and abs(p) < 90:
            step = np.remainder(np.diff(yaw[k:k + n]), 2 * np.pi)
            assert np.abs(step - 2 * np.pi / n).max() < 1e-9
        k += n


def _east_diffs(env, lat_deg, delta=0.01, n=3000):
    """Mean absolute difference of the environment between directions a
    fixed angle `delta` apart along the local east, at a latitude."""
    az = torch.as_tensor(np.random.default_rng(0).uniform(-np.pi, np.pi, n))
    la = torch.full_like(az, np.radians(lat_deg))

    def ray(a):
        return torch.stack([torch.cos(la) * torch.sin(a), torch.sin(la),
                            torch.cos(la) * torch.cos(a)], -1)

    step = delta / np.cos(np.radians(lat_deg))
    return (synth.env_lookup(env, ray(az)) - synth.env_lookup(env, ray(az + step))).abs().mean()


def test_texture_is_as_fine_at_the_poles():
    """The sphere's texture changes as fast near the poles as at the
    equator (neighbour differences within 2x); `synth.smooth_texture`,
    band-limited in equirectangular pixels, does not."""
    env = sphere.sphere_texture(11, 192, 384, 150.0 / 18.0)
    flat = synth.smooth_texture(11, 192, 384, 0.08)
    assert env.shape == (192, 384, 3) and float(env.min()) == 0.0 and float(env.max()) == 1.0
    for tex, fine in ((env, True), (flat, False)):
        eq = _east_diffs(tex, 0.0)
        ratios = [float(_east_diffs(tex, lat) / eq) for lat in (75.0, -75.0, 85.0, -85.0)]
        if fine:
            assert all(0.5 < r < 2.0 for r in ratios), ratios
        else:
            assert max(ratios) > 2.0, ratios


def test_small_sphere_is_correct(monkeypatch):
    """A small full sphere through `harness.run_cell`: correct, all views in
    one panorama, and the equirectangular canvas at least 99 % covered."""
    wl = spec.workload(BENCH, CELL)
    traffic = spec.traffic(wl["traffic"])
    traffic.update(SMALL)
    config = copy.deepcopy(spec.config_file(BENCH, wl["config"]))
    config["stitch_config"]["detector"].update({"max_keypoints": 256, "num_octaves": 3})
    covered = []
    judge = harness.judge

    def judged(folder, result, cfg, second_passes=()):
        (pr,) = result.panoramas
        covered.append(float(pr["coverage_by_mode"]["equirectangular"].mean()))
        return judge(folder, result, cfg, second_passes)

    monkeypatch.setattr(harness, "judge", judged)
    line = harness.run_cell(BENCH, wl, 2**33 + 5, 0.01, False, "cpu", 0.0, traffic=traffic,
                            config=config, limits={"checks": LIMITS})
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert line["checks"]["members_wrong"]["value"] == 0
    assert covered and min(covered) >= 0.99, covered


def test_config_is_rot800_equirectangular():
    """equirect800 pins every StitchConfig field and differs from rot800
    only in render.projections."""
    cfg = spec.config_file(BENCH, "equirect800")
    log = io.StringIO()
    spec.stitch_config(cfg, log=log)
    assert log.getvalue() == ""
    rot = spec.config_file(BENCH, "rot800")
    assert cfg["stitch_config"]["render"]["projections"] == ["equirectangular"]
    a = copy.deepcopy(cfg["stitch_config"])
    a["render"]["projections"] = rot["stitch_config"]["render"]["projections"]
    assert a == rot["stitch_config"]
    assert cfg["reduced"] == []
    entry = next(c for c in BENCH["configs"] if c["name"] == "equirect800")
    assert entry["file"] == "pano_bench/configs/equirect800.json" and entry["reduced"] == []
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["config"] == "equirect800" and cells[CELL]["chips"] == 1
    assert json.dumps(spec.traffic("ring100")) == json.dumps(
        {**spec.traffic("ring38"), "views": 100, "about": spec.traffic("ring100")["about"]})


def _ctx(*counters):
    kept = [spans.Kept((0, 1), [], dict(c)) for c in counters]
    return SimpleNamespace(store={spans.KEY: kept} if kept else {}, trace=None)


def test_render_slot_share_reads_the_counters():
    """100 x render.slots_live / render.slots over the kept stitches; None
    where no slot was counted (a planar scan, a program without the
    counters) or nothing was kept."""
    read = spec.metric_module("render_slot_share").read
    ctx = _ctx({"render.slots": 96, "render.slots_live": 60},
               {"render.slots": 32, "render.slots_live": 20, "render.tiles": 4})
    assert read(ctx) == pytest.approx(100.0 * 80 / 128)
    assert read(_ctx({"render.tiles": 4}, {"ba.lm_iterations": 40})) is None
    assert read(_ctx()) is None
