"""The share (%), by time, of the traced slice's full-pass device idle gaps
(between device events) that begin while the host is inside the program's
span `heuristic.policy`: the idle the FIFO dispatcher's Python owns. The
rest begins inside `env.step` or outside both."""
from port_bench import spans


def read(m):
    return spans.idle_share(m, "heuristic.policy")
