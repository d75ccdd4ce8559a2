"""The block12 kernels: the bounds of the three entry points a step runs
(`block12_fwd_res`, `block12_bwd_deep`, `block12_bwd_shallow`;
`work/block12.py`) over the device time of every `block12_*` group."""
from port_bench.work.block12 import b12_work
from port_bench.work.peaks import bound_s, itemsize


def read(r):
    ms = r.group_ms("block12_")
    if not ms:
        return None
    work = b12_work(*r.hw, r.traffic["classes"], itemsize(r.dtype))
    bound = sum(bound_s(*work[name], r.dtype) for name in (
        "block12_fwd_res", "block12_bwd_deep", "block12_bwd_shallow"))
    return 100.0 * bound * r.pairs / (ms / 1e3)
