"""Public API of the port, under the names of `autopanostitch_tpu.api` for
the stages it ports.

>>> from autopanostitch_tpu_torch import api
>>> iset = api.load_images(api.list_dataset("my_photos/"))
>>> result = api.stitch(iset, device="cuda")
"""

from __future__ import annotations

from autopanostitch_tpu_torch.config import (  # noqa: F401
    BlendConfig,
    RenderConfig,
    StitchConfig,
    StraightenConfig,
    default_config,
)
from autopanostitch_tpu_torch.models.straighten import straighten_rotations as straighten  # noqa: F401
from autopanostitch_tpu_torch.utils.image_io import (  # noqa: F401
    ImageSet,
    image_set_from_arrays,
    list_dataset,
    load_image_set as load_images,
)
from autopanostitch_tpu_torch.models.bundle import (  # noqa: F401
    Cameras,
    estimate_focal,
    run_bundle_adjustment as bundle_adjust,
)
from autopanostitch_tpu_torch.models.features import extract_features  # noqa: F401
from autopanostitch_tpu_torch.models.gain import (  # noqa: F401
    compute_gains_rotational as gain_compensate,
)
from autopanostitch_tpu_torch.models.pipeline import (  # noqa: F401
    MatchGraph,
    StitchResult,
    connected_components as recognize_panoramas,
    match_features,
    select_candidate_pairs,
    stitch,
    stitch_component,
    verify_matches as match_images,
)
from autopanostitch_tpu_torch.models.render import (  # noqa: F401
    compute_canvas,
    render_rotational as render_panorama,
)
from autopanostitch_tpu_torch.ops.blend import (  # noqa: F401
    linear_blend as linear_blending,
    multiband_blend as multiband_blending,
)
