"""csrc/raster_bwd.cu (raster_bwd_kernel): the soft silhouette's
backward. Bytes alone, as raster_soft."""
from gpubench.harness import roofline as R

KERNEL = "raster_bwd_kernel"


def matches(name: str) -> bool:
    return "raster_bwd_kernel" in name


def least_s(shapes: dict, peak: dict) -> float:
    return R.least_s(0, R.raster_bwd_bytes(shapes["soft_views"], shapes["img_size"],
                                           shapes["num_faces"]), peak)
