"""csrc/raster_fwd.cu, hard mode (raster_fwd_kernel<false>): the hard
rasterization of the mirrored views for their texture (training) or the
flow term's visibility (TTO). Bytes alone, as raster_soft."""
from gpubench.harness import roofline as R

KERNEL = "raster_fwd_kernel<false>"


def matches(name: str) -> bool:
    return "raster_fwd_kernel<false>" in name


def least_s(shapes: dict, peak: dict) -> float:
    return R.least_s(0, R.raster_fwd_bytes(shapes["hard_views"], shapes["img_size"],
                                           shapes["num_faces"]), peak)
