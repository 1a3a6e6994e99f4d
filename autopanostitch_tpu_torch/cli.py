"""Command-line entry point (port of the JAX package's `cli.py`, the
reference's `main.m`).

Enumerates dataset folders, stitches each into one or more panoramas on the
card, saves results with the reference's naming scheme, and prints
per-stage timings.

Usage:
  python -m autopanostitch_tpu_torch.cli <datasets_root_or_folder> \
      [--out results] [--projections spherical,cylindrical] \
      [--blend multiband] [--crop] [--force-planar] [--detector SIFT] \
      [--matching-method exhaustive] [--log log.txt] [--cache DIR] \
      [--profile DIR] [--device cuda]

A folder is treated as a single dataset if it directly contains images,
otherwise every image-bearing subfolder is a dataset (reference
`main.m:55-61` folder enumeration). `--device` names the torch device
(default `cuda`; there is no fallback: `cuda` without a card raises).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np


def find_datasets(root: str):
    from autopanostitch_tpu_torch.utils.image_io import list_dataset

    direct = list_dataset(root)
    if direct:
        return {os.path.basename(os.path.normpath(root)) or "dataset": direct}
    out = {}
    for name in sorted(os.listdir(root)):
        sub = os.path.join(root, name)
        if os.path.isdir(sub):
            imgs = list_dataset(sub)
            if imgs:
                out[name] = imgs
    return out


def build_config(args):
    from autopanostitch_tpu_torch.config import (
        BlendConfig,
        DetectorConfig,
        MatchingConfig,
        PostConfig,
        RenderConfig,
        StitchConfig,
        StraightenConfig,
    )

    return StitchConfig(
        detector=DetectorConfig(detector=args.detector),
        blend=BlendConfig(mode=args.blend),
        matching=MatchingConfig(
            method=args.matching_method,
            match_pairwise=args.pairwise,
            pairwise_rescue=not args.no_rescue,
        ),
        render=RenderConfig(
            projections=tuple(args.projections.split(",")),
            height_limit=args.size_limit,
            width_limit=args.size_limit,
            resize_image=not args.no_resize,
        ),
        straighten=StraightenConfig(force_planar_scan=args.force_planar),
        post=PostConfig(
            crop_panorama=args.crop,
            image_save_folder=args.out,
            image_write=not args.no_write,
            show_crop_bounding_box=args.show_crop_bbox,
            show_keypoints_plot=args.show_keypoints,
            show_adjacency_graph=args.show_adjacency,
        ),
    )


@contextlib.contextmanager
def _timed(timer, name: str):
    """timer.stage(name), then the reference's line for it."""
    with timer.stage(name):
        yield
    print(f"{name} execution time: {timer.durations[-1][1]:.3f} seconds")


def stitch_dataset(name: str, paths, cfg, out_dir: str, device="cuda", cache_dir=None):
    import time

    from autopanostitch_tpu_torch.models import pipeline
    from autopanostitch_tpu_torch.utils.image_io import load_image_set, save_image

    timer = pipeline.StageTimer(device)
    t_start = time.perf_counter()
    print(f"=== Dataset: {name} ({len(paths)} images) ===")
    with _timed(timer, "Image loading"):
        if cfg.render.resize_image:
            # `inputs.m resizeImage`: resize into the render limits
            limits = (cfg.render.height_limit, cfg.render.width_limit)
        else:  # native resolution (still padded to one common stack shape)
            limits = (1 << 30, 1 << 30)
        iset = load_image_set(paths, *limits)
    with _timed(timer, "Stitching (features/match/BA/render)"):
        result = pipeline.stitch(iset, cfg, device=device, cache_dir=cache_dir)
    with _timed(timer, "Crop & save"):
        for pano_i, pano in enumerate(result.panoramas):
            if not cfg.post.image_write:
                break  # `inputs.m imageWrite`: skip disk output
            panos = pano.get("projections_cropped") or pano["projections"]
            for mode, img in panos.items():
                fname = f"{mode}_{name}_{pano_i}.png"
                save_image(os.path.join(out_dir, fname), img)
                print(f"  wrote {fname}  {img.shape[1]}x{img.shape[0]}")
            for mode, img in (pano.get("projections_crop_bbox") or {}).items():
                fname = f"{mode}_{name}_{pano_i}_cropbbox.png"
                save_image(os.path.join(out_dir, fname), img)
                print(f"  wrote {fname}")
            # annotated panorama with per-image numbers
            # (reference `cropNsavePanorama.m:121-208` imgsNumsPanorama)
            for mode, img in (pano.get("projections_annotated") or {}).items():
                fname = f"{mode}_{name}_{pano_i}_annotated.png"
                save_image(os.path.join(out_dir, fname), img)
                print(f"  wrote {fname}")
        if cfg.post.image_write and (cfg.post.show_keypoints_plot
                                     or cfg.post.show_adjacency_graph):
            from autopanostitch_tpu_torch.models import annotate

            if cfg.post.show_adjacency_graph:
                g = result.graph
                adj = annotate.draw_adjacency_graph(
                    g.pairs, g.accepted, g.num_inliers, iset.n, result.components
                )
                save_image(os.path.join(out_dir, f"adjacency_{name}.png"), adj)
                print(f"  wrote adjacency_{name}.png")
            if cfg.post.show_keypoints_plot:
                feats = result.features
                xy, mask, scale = (t.cpu().numpy() for t in (feats.xy, feats.mask, feats.scale))
                for k in range(iset.n):
                    kp = annotate.draw_keypoints(iset.images[k], xy[k], mask[k], scale[k])
                    save_image(
                        os.path.join(out_dir, f"keypoints_{name}_{iset.names[k]}.png"),
                        kp,
                    )
                print(f"  wrote {iset.n} keypoint overlays")
    print(f"Total execution time: {time.perf_counter() - t_start:.3f} seconds")
    print(
        f"panoramas: {len(result.panoramas)}; components: "
        f"{len(np.unique(result.components))}; accepted pairs: "
        f"{int(result.graph.accepted.sum())}"
    )
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("root", help="dataset folder or folder of dataset folders")
    ap.add_argument("--out", default="results")
    ap.add_argument("--projections", default="spherical")
    ap.add_argument("--blend", default="multiband", choices=["multiband", "linear", "none"])
    ap.add_argument("--crop", action="store_true")
    ap.add_argument("--force-planar", action="store_true")
    ap.add_argument("--detector", default="SIFT",
                    help="feature detector (inputs.m input.detector): SIFT, VL_SIFT, HARRIS, "
                         "FAST, ORB, BRISK, SURF or KAZE")
    ap.add_argument("--matching-method", default="exhaustive",
                    choices=["exhaustive", "approximate"],
                    help="the pooled matcher (inputs.m:48): exact kNN, or a 32-d random-projection "
                         "sketch's candidates re-ranked exactly")
    ap.add_argument("--pairwise", action="store_true",
                    help="per-pair matching (inputs.m matchFeaturesPairwise)")
    ap.add_argument("--no-rescue", action="store_true",
                    help="disable the automatic pairwise rescue on fragmented discovery")
    ap.add_argument("--size-limit", type=int, default=800)
    ap.add_argument("--no-resize", action="store_true",
                    help="stitch at native resolution (inputs.m resizeImage=false)")
    ap.add_argument("--no-write", action="store_true",
                    help="skip writing panoramas (inputs.m imageWrite=false)")
    ap.add_argument("--show-crop-bbox", action="store_true",
                    help="save the inscribed-crop bounding box overlay")
    ap.add_argument("--show-keypoints", action="store_true",
                    help="save per-image keypoint overlays (inputs.m showKeypointsPlot)")
    ap.add_argument("--show-adjacency", action="store_true",
                    help="save the image-match adjacency graph plot (inputs.m showAdjacencyGraph)")
    ap.add_argument("--log", default=None)
    ap.add_argument("--cache", default=None, help="per-stage artifact cache dir (resume)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace into DIR/trace.json and print "
                         "the tracer's span table and counters (also DIR/spans.txt)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to stitch on (default cuda; no fallback)")
    args = ap.parse_args(argv)

    from autopanostitch_tpu_torch import device as device_mod

    device = device_mod.resolve(args.device)
    cfg = build_config(args)
    os.makedirs(args.out, exist_ok=True)
    datasets = find_datasets(args.root)
    if not datasets:
        print(f"no images found under {args.root}", file=sys.stderr)
        return 1

    def run():
        from autopanostitch_tpu_torch.utils.timing import device_profile

        with device_profile(args.profile):
            for name, paths in datasets.items():
                stitch_dataset(name, paths, cfg, args.out, device=device, cache_dir=args.cache)

    if args.log:
        from autopanostitch_tpu_torch.utils.timing import Tee

        with Tee(args.log):
            run()
    else:
        run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
