"""Host calls that queued device work (kernel launches, async copies and
sets) per step in the traced slice's full pass: a rollout's dispatcher and
env step, or a training step's window cut, forward, backward, clip and
AdamW. Shared by every `launches_per_step.<cell kind>` metric."""


def read(m):
    return m.slice.launches() / m.counters["steps"]
