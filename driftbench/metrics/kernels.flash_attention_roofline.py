"""kernels.flash_attention_roofline: the B4 flash-attention kernel's
share of its roofline over the profiled sub-window: the least time of
every call there (one a layer and prefill, from each prefill's bucket:
``flops.flash_bound_s``) over the device time of the kernels whose
name holds ``flash_attention`` (device trace). Nothing when no prefill
ran in the sub-window."""

from driftbench.flops import flash_bound_s


def read(run):
    if not run.trace or run.trace["flash_s"] <= 0:
        return None
    sizes = run.cell.sizes
    calls = [c for c in run.prefills if c.profiled]
    if not calls:
        return None
    bound = sum(sizes["n_layers"] * flash_bound_s(sizes, c.bucket)
                for c in calls)
    return 100.0 * bound / run.trace["flash_s"]
