"""The port's stage cache (`utils/cache.py`, `stitch(cache_dir=...)`)
against the JAX package's.

- The same fingerprints and file names for the same image set and config.
- A resumed `stitch` equals a fresh one at every stage: features, the
  match graph, each component's bundle adjustment (k1 included, which the
  reference's record leaves out) and the panoramas, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import parity_scenes
import synthdata
from autopanostitch_tpu import config as jconfig
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu.utils import cache as jcache
from autopanostitch_tpu.utils.image_io import ImageSet as JImageSet
from autopanostitch_tpu_torch import config as tconfig
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.utils import cache as tcache
from autopanostitch_tpu_torch.utils.image_io import ImageSet
from test_torch_pipeline import one_torch_thread  # noqa: F401


def test_fingerprint_and_store_match_the_reference(tmp_path):
    names, sizes = ["a", "b"], np.array([[380, 420], [380, 420]], np.int32)
    for section in ("detector", "matching", "image_match", "bundle"):
        t, j = repr(getattr(tconfig.StitchConfig(), section)), repr(getattr(jconfig.StitchConfig(), section))
        assert t == j
        assert tcache.fingerprint(names, sizes, t) == jcache.fingerprint(names, sizes, j)
    c = tcache.StageCache(str(tmp_path))
    c.save("k", "features", xy=np.ones((4, 2), np.float32), mask=np.array([True, False] * 2))
    out = jcache.StageCache(str(tmp_path)).load("k", "features")
    assert set(out) == {"xy", "mask"} and out["mask"].dtype == bool
    assert c.load("k", "graph") is None


def _planar_pair():
    env = synthdata.texture(0, 400, 760)
    views = [env[0:380, 0:420], env[20:400, 320:740]]
    sizes = np.array([v.shape[:2] for v in views], np.int32)
    stack = np.zeros((2, 384, 420, 3), np.float32)
    for k, v in enumerate(views):
        stack[k, : v.shape[0], : v.shape[1]] = v
    fields = dict(detector=dict(max_keypoints=384, num_octaves=3),
                  matching=dict(max_matches_per_pair=256), image_match=dict(ransac_batch=256),
                  straighten=dict(force_planar_scan=True))
    return stack, sizes, fields


def _cfg(module, fields):
    import dataclasses

    base = module.StitchConfig()
    return base.replace(**{s: dataclasses.replace(getattr(base, s), **f) for s, f in fields.items()})


def test_cache_files_are_the_references(tmp_path):
    """The planar pair of tests/test_cache.py stitched with a cache by both
    packages: the same three file names (features, graph, ba<label>)."""
    stack, sizes, fields = _planar_pair()
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    tpipe.stitch(ImageSet(images=stack, sizes=sizes, names=["a", "b"]), _cfg(tconfig, fields),
                 device="cpu", cache_dir=str(tdir))
    jpipe.stitch(JImageSet(images=stack, sizes=sizes, names=["a", "b"]), _cfg(jconfig, fields),
                 cache_dir=str(jdir))
    files = sorted(os.listdir(tdir))
    assert files == sorted(os.listdir(jdir))
    stages = sorted(f.split("_", 1)[1] for f in files)
    assert len(stages) == 3 and stages[0].startswith("ba") and stages[1:] == ["features.npz",
                                                                                "graph.npz"]


@pytest.fixture(scope="module")
def config3_cached(tmp_path_factory):
    d = tmp_path_factory.mktemp("cache")
    iset, cfg = parity_scenes.config3_spherical_ba()
    fresh = tpipe.stitch(iset, cfg, seed=0, device="cpu", cache_dir=str(d))
    timer = tpipe.StageTimer()
    resumed = tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer, cache_dir=str(d))
    return fresh, resumed, timer, d


def test_resumed_stitch_equals_fresh(config3_cached):
    fresh, resumed, timer, d = config3_cached
    # the resumed run skipped every cached stage
    assert set(timer.report()) == {"features", "gain", "render"}
    assert len(list(d.glob("*_features.npz"))) == 1 and len(list(d.glob("*_graph.npz"))) == 1
    assert len(list(d.glob("*_ba*.npz"))) == len(fresh.panoramas)
    for a, b in zip(fresh.features, resumed.features):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for k in tpipe.MatchGraph.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(resumed.graph, k), getattr(fresh.graph, k))
    np.testing.assert_array_equal(resumed.components, fresh.components)
    assert len(resumed.panoramas) == len(fresh.panoramas) == 1
    p, q = fresh.panoramas[0], resumed.panoramas[0]
    for f in ("R", "f", "cx", "cy", "k1"):
        a, b = getattr(p["ba"]["cameras"], f), getattr(q["ba"]["cameras"], f)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert p["ba"]["cameras"].k1 is not None
    np.testing.assert_array_equal(p["R_render"], q["R_render"])
    for mode in p["projections"]:
        np.testing.assert_array_equal(p["projections"][mode], q["projections"][mode])
        np.testing.assert_array_equal(p["projections_cropped"][mode],
                                      q["projections_cropped"][mode])
