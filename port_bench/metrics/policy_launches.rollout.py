"""Host calls that queued device work (port_bench/tracing.LAUNCH_CALLS) per
traced step that start inside the program's span `heuristic.policy`: the
FIFO dispatcher's share of `launches_per_step.rollout`, in the traced
slice's full pass."""
from port_bench import spans


def read(m):
    return spans.launches_per_step(m, "heuristic.policy")
