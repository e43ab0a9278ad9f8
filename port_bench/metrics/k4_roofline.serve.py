"""K4's share of its roofline in the traced slice, in %: the least time its
launches could take at the card's peaks over their time on the device. Each
launch's width comes from the recorded input shapes of the op
`swarm_ode_tpu_torch::segment_sum_planned` (data (nodes, width)), its edges
and distinct sources from the traced batches' graphs as the benchmark
counts them (port_bench/counts.k4_bytes_ops)."""
from port_bench import counts

KERNEL = "segment_sum_kernel"
OP = "swarm_ode_tpu_torch::segment_sum_planned"


def read(m):
    launches, us = m.slice.device_us(KERNEL)
    if launches == 0 or us <= 0:
        return None
    c = m.counters
    widths = []  # (width, calls) over the slice
    for op in m.slice.ops:
        if op["name"] == OP and op["shapes"] and op["shapes"][0]:
            widths.append((int(op["shapes"][0][-1]), int(op["count"])))
    calls = sum(n for _, n in widths)
    if calls == 0:
        return None
    bound = 0.0  # summed over the op's calls
    for edges, sources in zip(c["valid_edges"], c["distinct_sources"]):
        for width, n in widths:
            t, _ = counts.bound_s(*counts.k4_bytes_ops(width, edges, sources, c["nodes"]))
            bound += t * n / len(c["valid_edges"])
    # The mean call's bound times the launches the device ran, over their time.
    return 100.0 * (bound / calls) * launches / (us / 1e6)
