"""Host calls that queued device work per served batch in the traced slice:
graph, edge list, plan, the solve's SAGE layers (K4 among them), decoder."""


def read(m):
    return m.slice.launches() / m.counters["batches"]
