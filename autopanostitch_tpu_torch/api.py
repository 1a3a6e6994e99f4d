"""Public API of the port, under the names of `autopanostitch_tpu.api`.

>>> from autopanostitch_tpu_torch import api
>>> iset = api.load_images(api.list_dataset("my_photos/"))
>>> result = api.stitch(iset, device="cuda")

Multi-GPU: start one process per card (`torchrun --nproc_per_node=<gpus>
script.py`); each calls `api.stitch_multichip(iset)` with the same set,
config and seed, and each gets the same result.
"""

from __future__ import annotations

# entry points and configuration
from autopanostitch_tpu_torch.config import (  # noqa: F401
    BlendConfig,
    RenderConfig,
    StitchConfig,
    StraightenConfig,
    default_config,
)
from autopanostitch_tpu_torch.models.pipeline import (  # noqa: F401
    MatchGraph,
    StitchResult,
    connected_components as recognize_panoramas,
    match_features,
    second_pass_matching,
    select_candidate_pairs,
    stitch,
    stitch_component,
    verify_matches as match_images,
)

# stages under reference-style names
from autopanostitch_tpu_torch.utils.image_io import (  # noqa: F401
    ImageSet,
    image_set_from_arrays,
    list_dataset,
    load_image,
    load_image_set as load_images,
    resize_fillcrop,
    resize_fit,
    resize_pad,
    save_image,
)
from autopanostitch_tpu_torch.models.features import extract_features  # noqa: F401
from autopanostitch_tpu_torch.models.bundle import (  # noqa: F401
    Cameras,
    estimate_focal,
    initialize_cameras_summary,
    run_bundle_adjustment as bundle_adjust,
)
from autopanostitch_tpu_torch.models.bundle_h import (  # noqa: F401
    run_bundle_adjustment_h as bundle_adjust_h,
)
from autopanostitch_tpu_torch.models.straighten import straighten_rotations as straighten  # noqa: F401
from autopanostitch_tpu_torch.models.gain import (  # noqa: F401
    compute_gains_planar as gain_compensate_planar,
    compute_gains_rotational as gain_compensate,
)
from autopanostitch_tpu_torch.models.render import (  # noqa: F401
    compute_canvas,
    render_rotational as render_panorama,
)
from autopanostitch_tpu_torch.models.planar import (  # noqa: F401
    chain_to_anchor,
    composite_from_abs,
    render_planar,
)
from autopanostitch_tpu_torch.ops.blend import (  # noqa: F401
    linear_blend as linear_blending,
    multiband_blend as multiband_blending,
)
from autopanostitch_tpu_torch.models.crop import (  # noqa: F401
    crop_bbox,
    crop_panorama,
    largest_inscribed_rect,
    mask_from_color,
)
from autopanostitch_tpu_torch.models.annotate import (  # noqa: F401
    draw_adjacency_graph,
    draw_annotations,
    draw_keypoints,
    draw_matches,
    warped_boxes_planar,
    warped_boxes_rotational,
)
from autopanostitch_tpu_torch.parallel.pipeline import (  # noqa: F401
    stitch_multichip,
)
