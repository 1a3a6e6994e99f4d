"""End to end: the detector and estimator options through the port's
`pipeline.stitch` on the CPU, against the JAX package's `pipeline.stitch` on
the same scene and config.

Scenes are the parity scenes (tests/parity_scenes.py) with one option set
each: ORB with MLESAC and the adaptive RANSAC budget, SURF, KAZE (config 3,
the spherical 8-view scene), and the planar pair (config 1) verified with
the affine model. The two packages draw different RANSAC hypotheses, so the
graph is held exactly where it is decided (pairs, accepted pairs,
components) and the numbers within the golden tolerances: num_inliers rtol
0.05 / atol 5, focal lengths rtol 0.005, rotations atol 0.01, planar
homographies rtol 0.02 / atol 0.05.
"""

import dataclasses

import numpy as np
import pytest

import parity_scenes
from autopanostitch_tpu.models import pipeline as jpipe
from autopanostitch_tpu_torch.models import features as tfeat
from autopanostitch_tpu_torch.models import pipeline as tpipe
from test_torch_pipeline import one_torch_thread  # noqa: F401


def _orb_mlesac_adaptive():
    iset, cfg = parity_scenes.config3_spherical_ba()
    return iset, cfg.replace(
        detector=dataclasses.replace(cfg.detector, detector="ORB"),
        image_match=dataclasses.replace(cfg.image_match, method="mlesac",
                                        adaptive_first_batch=64))


def _detector(name):
    """SURF / KAZE at 256 keypoints an image: their 80 px windows make the
    plain (CPU) window phase the slowest part of the test."""
    def scene():
        iset, cfg = parity_scenes.config3_spherical_ba()
        return iset, cfg.replace(detector=dataclasses.replace(cfg.detector, detector=name,
                                                              max_keypoints=256))
    return scene


def _planar_affine():
    iset, cfg = parity_scenes.config1_planar_pair()
    return iset, cfg.replace(image_match=dataclasses.replace(
        cfg.image_match, transformation_type="affine"))


SCENES = {"orb_mlesac_adaptive": _orb_mlesac_adaptive, "surf": _detector("SURF"),
          "kaze": _detector("KAZE"), "planar_affine": _planar_affine}


@pytest.mark.parametrize("name", list(SCENES))
def test_option_stitches_like_jax(name):
    iset, cfg = SCENES[name]()
    ref = parity_scenes.extract_artifacts(iset, jpipe.stitch(iset, cfg, seed=0))
    res = tpipe.stitch(iset, cfg, seed=0, device="cpu")
    got = parity_scenes.extract_artifacts(iset, res)
    for k in ("pairs", "accepted", "components", "n_panoramas"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["n_keypoints"], ref["n_keypoints"], rtol=0.02, atol=3)
    np.testing.assert_allclose(got["num_inliers"], ref["num_inliers"], rtol=0.05, atol=5)
    assert ref["n_panoramas"] >= 1 and ref["accepted"].any()
    for k, v in ref.items():
        if k.endswith("_f"):
            np.testing.assert_allclose(got[k], v, rtol=0.005, err_msg=k)
        elif k.endswith("_R"):
            np.testing.assert_allclose(got[k], v, atol=0.01, err_msg=k)
        elif k.endswith("H_abs"):
            np.testing.assert_allclose(got[k], v, rtol=0.02, atol=0.05, err_msg=k)
    if name == "orb_mlesac_adaptive":
        assert res.features.desc.shape[-1] == 256
        stats = tpipe.rs.verify_pairs.last_stats
        assert stats["first"] == 64 and stats["total"] > 64
    if name == "planar_affine":
        H = np.asarray(res.graph.H)[np.asarray(res.graph.accepted)]
        np.testing.assert_allclose(H[:, 2], np.tile([0.0, 0.0, 1.0], (len(H), 1)), atol=1e-6)


def test_check_supported_takes_each_detectors_width():
    """On the card, `stitch` checks B1's width before any work. The old
    check took descriptor_width^2 * descriptor_bins for every detector,
    which is 128 for ORB, whose descriptors are 256 bits: it passed ORB at
    the wrong width. The check now takes the width each detector gives,
    and the descriptor grid only for the detectors that run B2."""
    iset, cfg = parity_scenes.config3_spherical_ba()
    orb = cfg.replace(detector=dataclasses.replace(cfg.detector, detector="ORB"))
    det = orb.detector
    assert det.descriptor_width ** 2 * det.descriptor_bins == 128  # the old, wrong width
    assert tfeat.descriptor_width(det) == 256
    for name, width in (("HARRIS", 256), ("FAST", 256), ("BRISK", 256), ("SIFT", 128),
                        ("SURF", 128), ("KAZE", 128)):
        assert tfeat.descriptor_width(dataclasses.replace(det, detector=name)) == width
    import torch

    cuda = torch.device("cuda")
    tpipe._check_supported(orb, cuda)  # passes: 256 is a width B1 takes
    # a grid B2 lacks matters to SURF, not to ORB (no B2 on its path)
    odd = dataclasses.replace(det, descriptor_width=5)
    tpipe._check_supported(orb.replace(detector=odd), cuda)
    with pytest.raises(ValueError, match="descriptor_width"):
        tpipe._check_supported(orb.replace(detector=dataclasses.replace(odd, detector="SURF")),
                               cuda)
    # 2 * 2 * 6 = 24 bins: B1 takes it as 32 zero-padded columns
    tpipe._check_supported(cfg.replace(detector=dataclasses.replace(
        cfg.detector, descriptor_width=2, descriptor_bins=6)), cuda)
    with pytest.raises(ValueError, match="16"):  # B1's pooled k
        tpipe._check_supported(cfg.replace(matching=dataclasses.replace(cfg.matching, k=17)),
                               cuda)
