"""Host calls that wait for the device (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, the blocking `cudaMemcpy`)
in the device trace that start inside a stitch's root span, a folder: the
harness's own sync after each stitch and the stage timer's reads after it
fall outside."""

from pano_bench import spans

UNIT = "syncs/folder"
LAYER = "api.stitch, models/pipeline"
MOVES = "stitch_s"
install = spans.install


def read(ctx):
    return spans.host_syncs(ctx)
