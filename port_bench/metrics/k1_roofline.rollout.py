"""K1's share of its roofline in the traced slice, in %: the least time its
launches could take at the card's peaks (bytes and operations counted from
each launch's rows, cells and envs: port_bench/counts.k1_bytes_ops) over
their time on the device. Bound by whichever of the two is larger."""
from port_bench import counts

KERNEL = "bfs_query_kernel"


def read(m):
    launches, us = m.slice.device_us(KERNEL)
    if launches == 0 or us <= 0:
        return None
    c = m.counters
    nbytes, ops = counts.k1_bytes_ops(c["k1_rows"], c["k1_cells"], c["k1_envs"])
    bound_s, _ = counts.bound_s(nbytes, ops)
    return 100.0 * launches * bound_s / (us / 1e6)
