"""The torch port's slice as a whole against the JAX package.

- `stitch` on `config3_spherical_ba` against the JAX package's recorded
  golden, with tests/test_parity.py's tolerances.
- A stage started from the JAX package's own output (`convert`).
- The converters that start a port stage from JAX output.
- The port never imports jax and never moves to the CPU when CUDA is
  asked for. (The recovery paths, the planar path and the other
  projections: tests/test_torch_recovery.py, test_torch_planar.py and
  test_torch_projections.py.)
"""

import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import parity_scenes
import autopanostitch_tpu_torch
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu.ops.sift import SiftFeatures as JaxSiftFeatures
from autopanostitch_tpu_torch import convert
from autopanostitch_tpu_torch.models import pipeline as tpipe
from autopanostitch_tpu_torch.ops import sampling as tsamp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread per test module. Tier-1 runs six test workers on
    the machine's cores, and torch's per-process thread pool on top of them
    oversubscribes the cores (test_torch_projections.py ran 849 s in such a
    run against 59 s alone); these tests are small and run as fast on one
    thread. The torch test modules import this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_golden(fresh, golden):
    """tests/test_parity.py's comparison, verbatim in its tolerances."""
    assert set(fresh) == set(golden)
    np.testing.assert_array_equal(fresh["pairs"], golden["pairs"])
    np.testing.assert_array_equal(fresh["accepted"], golden["accepted"])
    np.testing.assert_array_equal(fresh["components"], golden["components"])
    assert fresh["n_panoramas"] == golden["n_panoramas"]
    np.testing.assert_allclose(fresh["n_keypoints"], golden["n_keypoints"], rtol=0.02, atol=3)
    np.testing.assert_allclose(fresh["num_inliers"], golden["num_inliers"], rtol=0.05, atol=5)
    for k, gv in golden.items():
        fv = fresh[k]
        if k.endswith("_shape"):
            np.testing.assert_allclose(fv, gv, atol=2)
        elif k.endswith("_coverage"):
            np.testing.assert_allclose(fv, gv, atol=0.01)
        elif k.endswith("_mean"):
            np.testing.assert_allclose(fv, gv, atol=1.5)
        elif k.endswith("H") or k.endswith("H_abs"):
            np.testing.assert_allclose(fv, gv, rtol=0.02, atol=0.05)
        elif k.endswith("_f"):
            np.testing.assert_allclose(fv, gv, rtol=0.005)
        elif k.endswith("_R"):
            np.testing.assert_allclose(fv, gv, atol=0.01)
        elif "gains" in k:
            np.testing.assert_allclose(fv, gv, rtol=0.01, atol=0.01)
        elif k.endswith("straightened"):
            assert bool(fv) == bool(gv)


@pytest.fixture(scope="module")
def config3_run():
    iset, cfg = parity_scenes.config3_spherical_ba()
    timer = tpipe.StageTimer()
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu", timer=timer)
    return iset, cfg, res, timer


def test_config3_golden_parity(config3_run):
    iset, _, res, timer = config3_run
    with np.load(os.path.join(REPO, "tests", "goldens", "config3_spherical_ba.npz")) as z:
        golden = {k: z[k] for k in z.files}
    _assert_golden(parity_scenes.extract_artifacts(iset, res), golden)
    assert set(timer.report()) == {"features", "matching", "ransac", "pairwise_rescue",
                                   "bundle_adjustment", "gain", "render"}


def test_stage_from_jax_output(config3_run):
    """The JAX package matches and verifies the port's features; its graph
    and features cross over through `convert`, and the port's
    `stitch_component` finishes the panorama within the golden tolerances."""
    iset, cfg, res, _ = config3_run
    f = res.features
    jfeats = JaxSiftFeatures(*[jnp.asarray(x.numpy()) for x in f])
    pairs, pair_idx, pair_mask, counts = jpipe.match_features(jfeats, cfg)
    pairs, pair_idx, pair_mask = jpipe.select_candidate_pairs(
        pairs, pair_idx, pair_mask, counts, cfg.image_match.m_brown_lowe)
    jgraph = jpipe.verify_matches(jfeats, pairs, pair_idx, pair_mask, counts, cfg,
                                  jpipe.host_prng_key(0))
    graph = convert.match_graph(jgraph)
    feats = convert.sift_features(jfeats, "cpu")
    np.testing.assert_array_equal(graph.pairs, res.graph.pairs)
    np.testing.assert_array_equal(graph.accepted, res.graph.accepted)
    images = torch.as_tensor(iset.images)
    feathers = tsamp.feather_stack(torch.as_tensor(iset.sizes), *images.shape[1:3])
    pano = tpipe.stitch_component(iset, graph, feats, np.arange(iset.n), cfg, images, feathers)
    ref = res.panoramas[0]
    np.testing.assert_allclose(pano["ba"]["cameras"].f.numpy(), ref["ba"]["cameras"].f.numpy(),
                               rtol=0.005)
    np.testing.assert_allclose(pano["R_render"], ref["R_render"], atol=0.01)
    np.testing.assert_allclose(pano["gains"]["spherical"], ref["gains"]["spherical"],
                               rtol=0.01, atol=0.01)


def test_convert_fields():
    rng = np.random.default_rng(0)
    jf = JaxSiftFeatures(xy=jnp.asarray(rng.uniform(size=(2, 5, 2))), scale=jnp.ones((2, 5)),
                         orientation=jnp.zeros((2, 5)), response=jnp.ones((2, 5)),
                         desc=jnp.asarray(rng.uniform(size=(2, 5, 128))),
                         mask=jnp.asarray(rng.uniform(size=(2, 5)) > 0.5))
    tf = convert.sift_features(jf, "cpu")
    assert tf.mask.dtype == torch.bool and tf.desc.dtype == torch.float32
    np.testing.assert_array_equal(tf.mask.numpy(), np.asarray(jf.mask))
    from autopanostitch_tpu.models.bundle import Cameras as JaxCameras

    cams = convert.cameras(JaxCameras(R=jnp.eye(3)[None], f=jnp.ones(1) * 300, cx=jnp.zeros(1),
                                      cy=jnp.zeros(1), k1=None), "cpu")
    assert cams.k1 is None and cams.R.shape == (1, 3, 3)
    assert convert.gains(np.ones((2, 3))).dtype == np.float32


def test_convert_homography_ba_and_canvas_fields():
    from autopanostitch_tpu.models import bundle_h as jbh
    from autopanostitch_tpu.models import render as jrender

    Hs = np.array([[[1.0, 0.0, -100.0], [0.0, 1.0, -5.0], [0.0, 0.0, 1.0]]], np.float32)
    u = np.random.default_rng(1).uniform(110, 300, (1, 30, 2)).astype(np.float32)
    hba = jbh.run_bundle_adjustment_h(np.array([[0, 1]]), Hs, (u, u - [100, 5], np.ones((1, 30))),
                                      2)
    out = convert.homography_ba(hba)
    assert out["H_abs"].dtype == np.float32 and out["H_abs"].shape == (2, 3, 3)
    assert out["reachable"].dtype == bool and out["reachable"].all()
    assert out["anchor"] == hba["anchor"] and isinstance(out["final_cost"], float)
    np.testing.assert_allclose(out["H_init"], hba["H_init"])
    pano = convert.homography_ba({"H_abs": hba["H_abs"], "reachable": hba["reachable"],
                                  "anchor": np.int64(0)})
    assert pano["anchor"] == 0 and "final_cost" not in pano
    R = np.stack([np.eye(3), np.eye(3)]).astype(np.float32)
    K = np.tile(np.array([[200, 0, 99.5], [0, 200, 79.5], [0, 0, 1]], np.float32), (2, 1, 1))
    cj = jrender.compute_canvas(R, K, np.array([[160, 200]] * 2), "stereographic")
    ct = convert.canvas(cj)
    assert set(ct) == set(cj) and isinstance(ct["f_pan"], float) and isinstance(ct["Hc"], int)
    assert ct["R_ref"].dtype == np.float32 and ct["R_ref"].shape == (3, 3)


def test_port_imports_no_jax():
    """Every port module (and chip_smoke.py) imports with jax and the JAX
    package made unimportable, and no source line imports either."""
    mods = [m.name for m in pkgutil.walk_packages(autopanostitch_tpu_torch.__path__,
                                                  "autopanostitch_tpu_torch.")]
    assert {"autopanostitch_tpu_torch.api", "autopanostitch_tpu_torch.config",
            "autopanostitch_tpu_torch.utils.image_io", "autopanostitch_tpu_torch.models.crop",
            "autopanostitch_tpu_torch.models.straighten", "autopanostitch_tpu_torch.cli",
            "autopanostitch_tpu_torch.models.annotate", "autopanostitch_tpu_torch.utils.cache",
            "autopanostitch_tpu_torch.utils.timing", "autopanostitch_tpu_torch.utils.threefry",
            "autopanostitch_tpu_torch.native", "autopanostitch_tpu_torch.parallel.mesh",
            "autopanostitch_tpu_torch.parallel.sharded", "autopanostitch_tpu_torch.parallel.pipeline",
            "autopanostitch_tpu_torch.utils.perturb", "autopanostitch_tpu_torch.utils.real_data",
            "autopanostitch_tpu_torch.utils.flops"} <= set(mods)
    code = ("import importlib, sys\n"
            "sys.modules['autopanostitch_tpu'] = None\n"
            "sys.modules['jax'] = None\n"
            "import autopanostitch_tpu_torch, autopanostitch_tpu_torch.api\n"
            f"for m in {mods!r} + ['chip_smoke']: importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules if m.startswith(('jax.', 'autopanostitch_tpu.'))))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    banned = ("import jax", "from jax", "import autopanostitch_tpu ", "import autopanostitch_tpu.",
              "from autopanostitch_tpu ", "from autopanostitch_tpu.")
    for root in (os.path.join(REPO, "autopanostitch_tpu_torch"), os.path.join(REPO, "chip_smoke.py")):
        files = [root] if root.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")]
        for path in files:
            for line in open(path):
                assert not line.strip().startswith(banned), path


def test_stitch_on_cuda_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the no-fallback check needs one without")
    iset, cfg = parity_scenes.config3_spherical_ba()
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.stitch(iset, cfg, device="cuda")
    with pytest.raises(ValueError):
        from autopanostitch_tpu_torch.kernels import knn

        d = torch.zeros((4, 128), device="meta")
        i = torch.zeros(4, dtype=torch.int32, device="meta")
        knn.knn(d, i, d, i, 2)


def test_rescue_trigger_matches_jax():
    g = tpipe.MatchGraph(pairs=np.array([[0, 1], [1, 2], [3, 4], [4, 5]]), pair_idx=None,
                         pair_mask=None, H=None, inliers=None, num_inliers=None,
                         accepted=np.array([True, True, True, True]), counts=None)
    votes = np.zeros((6, 6), np.int32)
    votes[0, 1] = votes[1, 0] = votes[1, 2] = votes[2, 1] = 40
    votes[3, 4] = votes[4, 3] = votes[4, 5] = votes[5, 4] = 40
    for cross in (0, 30):
        votes[2, 3] = votes[3, 2] = cross
        comps = np.array([0, 0, 0, 1, 1, 1])
        assert tpipe._rescue_suspicious(comps, votes, g) == jpipe._rescue_suspicious(comps, votes, g)
    assert tpipe._rescue_suspicious(np.array([0, 0, 1]), votes[:3, :3], g) is True

