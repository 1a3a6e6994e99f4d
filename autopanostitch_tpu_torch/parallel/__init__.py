"""Multi-GPU stitching over torch.distributed: the process mesh
(`mesh.py`), the sharded stages (`sharded.py`) and `stitch_multichip`
(`pipeline.py`)."""
