"""csrc/correlation.cu (corr_tile_kernel, corr_split_kernel): the flow
net's cost volumes, 5 at md=4 and 10 at md=2 a pass, over the pairs of a
flow call. Each launch is given the mean least time of its pass (whole
passes in the trace then sum exactly)."""
from gpubench.harness import roofline as R

KERNEL = "corr_tile_kernel / corr_split_kernel"


def matches(name: str) -> bool:
    return "corr_tile_kernel" in name or "corr_split_kernel" in name


def pass_ops_bytes(pairs: int, net_hw) -> tuple:
    ops = nbytes = 0
    for md, C, H, W, per in R.flow_levels(net_hw):
        o, b = R.corr_ops_bytes(pairs, md, C, H, W)
        ops += per * o
        nbytes += per * b
    return ops, nbytes


def ops_per_pass(config: dict) -> int:
    """Operations of one pass over one pair (the step's count of work)."""
    return pass_ops_bytes(1, config["flow_net_hw"])[0]


def least_s(shapes: dict, peak: dict) -> float:
    total = 0.0
    launches = 0
    for md, C, H, W, per in R.flow_levels(shapes["flow_net_hw"]):
        total += per * R.least_s(*R.corr_ops_bytes(shapes["flow_pairs"], md, C, H, W), peak)
        launches += per
    return total / launches
