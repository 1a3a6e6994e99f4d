"""Multi-GPU end-to-end stitching over torch.distributed (port of
`parallel/pipeline.py`).

`stitch_multichip` is `models/pipeline.stitch` with its heavy stages split
across the ranks of a `parallel.mesh.Mesh` (`parallel/sharded.py`):

  SIFT            -> images over ranks (kernel B2 on each rank's images)
  pooled kNN      -> query rows over ranks, the pool whole on every rank
                     (kernel B1's pooled mode)
  RANSAC          -> pairs over ranks, minimal sets drawn alike on every rank
  discovery, the rescue, the second passes, BA -> whole on every rank
                     (O(N) cameras; the rescue and the pairwise second pass
                     on B1's pair-list mode)
  gain statistics -> grid chunks over ranks, partial sums all-reduced
  render          -> canvas tiles over ranks, gathered

Every rank calls it with the same image set, config and seed (as
`torchrun` starts them) and returns the same StitchResult: the reference's
`parpool`/`parfor` (`main.m:39-47`) as SPMD processes.
"""

from __future__ import annotations

import torch

from autopanostitch_tpu_torch.config import StitchConfig
from autopanostitch_tpu_torch.models import features as features_stage
from autopanostitch_tpu_torch.models import pipeline as pl
from autopanostitch_tpu_torch.parallel import mesh as pmesh
from autopanostitch_tpu_torch.utils import trace
from autopanostitch_tpu_torch.utils.image_io import ImageSet


def stitch_multichip(image_set: ImageSet, cfg: StitchConfig = StitchConfig(), mesh=None,
                     seed: int = 0, timer=None) -> pl.StitchResult:
    """Stitch an unordered image set with the heavy stages split across the
    ranks of `mesh` (default: `mesh.make_mesh()`, this rank's card).

    The result of `pipeline.stitch` on the same set, on every rank. SIFT
    only (other detectors raise ValueError: they run through `stitch`); the
    pooled matcher always, exhaustive in float32, whatever
    `matching.match_pairwise`, `method` and `tpu.compute_dtype` say; RANSAC
    with a fixed budget (no `adaptive_first_batch`), as the reference's
    multi-chip path. `timer` a `pipeline.StageTimer` or None. The stitch is
    the tracer's root span (`utils/trace.py`), tagged with this rank."""
    if cfg.detector.detector.upper() not in features_stage.SHARDED_DETECTORS:
        raise ValueError("stitch_multichip shards the SIFT extractor; detector="
                         f"{cfg.detector.detector!r} runs through pipeline.stitch")
    mesh = mesh if mesh is not None else pmesh.make_mesh()
    with trace.stitch(image_set.names, image_set.sizes, rank=mesh.rank):
        return _stitch_multichip(image_set, cfg, mesh, seed, timer)


def _stitch_multichip(image_set: ImageSet, cfg: StitchConfig, mesh, seed: int,
                      timer) -> pl.StitchResult:
    dev = mesh.device
    pl._check_supported(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = image_set.n
    with pl._stage(timer, "features"):
        images = pl._upload(image_set.images, dev)
        feats = features_stage.extract_features(images, image_set.sizes, cfg.detector, mesh=mesh)
    feathers = pl._feathers(image_set.sizes, images)
    with pl._stage(timer, "matching"):
        pairs, pair_idx, pair_mask, counts, votes = pl.match_features(feats, cfg, mesh=mesh)
        if len(pairs):
            pairs, pair_idx, pair_mask = pl.select_candidate_pairs(
                pairs, pair_idx, pair_mask, counts, cfg.image_match.m_brown_lowe)
    with pl._stage(timer, "ransac"):
        graph = pl.verify_matches(feats, pairs, pair_idx, pair_mask, counts, cfg, gen, mesh=mesh)
    with trace.span("components"):
        comps = pl.connected_components(n, graph.pairs, graph.accepted)
    # the rescue runs whole on every rank: it fires only on a suspicious
    # split, and the ranks must keep identical graphs
    with pl._stage(timer, "pairwise_rescue"):
        graph, comps, rescue_adopted = pl.pairwise_rescue(
            feats, graph, comps, n, cfg, pl.derived_generator(dev, seed, 3), votes=votes)
    graph_is_pairwise = cfg.matching.match_pairwise or rescue_adopted
    panoramas = pl.stitch_components(image_set, graph, comps, feats, images, feathers, cfg, seed,
                                     graph_is_pairwise, timer=timer, mesh=mesh)
    return pl.StitchResult(panoramas=panoramas, graph=graph, components=comps, features=feats)
