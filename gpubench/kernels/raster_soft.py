"""csrc/raster_fwd.cu, soft mode (raster_fwd_kernel<true>): the soft
silhouette of every view of a step. Its work depends on the scene (the
pairs in radius), which the trace does not give per launch, so its least
time is counted from its bytes alone (a lower bound of the least time)."""
from gpubench.harness import roofline as R

KERNEL = "raster_fwd_kernel<true>"


def matches(name: str) -> bool:
    return "raster_fwd_kernel<true>" in name


def least_s(shapes: dict, peak: dict) -> float:
    return R.least_s(0, R.raster_fwd_bytes(shapes["soft_views"], shapes["img_size"],
                                           shapes["num_faces"]), peak)
