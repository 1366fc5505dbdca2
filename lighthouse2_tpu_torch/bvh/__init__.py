from lighthouse2_tpu_torch.bvh.builder import build_sah_bvh  # noqa: F401
from lighthouse2_tpu_torch.bvh.traverse import (  # noqa: F401
    DeviceBVH, build_device_bvh, bvh_intersect, bvh_occluded,
)
