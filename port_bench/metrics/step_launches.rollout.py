"""Host calls that queued device work (port_bench/tracing.LAUNCH_CALLS) per
traced step that start inside the program's span `env.step`: the env
step's share of `launches_per_step.rollout` (its replan, K1 included), in
the traced slice's full pass. With `policy_launches.rollout`, what is left
is the benchmark's own draws and the rollout loop's totals."""
from port_bench import spans


def read(m):
    return spans.launches_per_step(m, "env.step")
