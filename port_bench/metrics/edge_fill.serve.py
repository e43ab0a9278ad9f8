"""100 x the program's counter `serve.edges_valid` over `serve.edge_slots`
(valid edges and slots of `graphs/temporal.temporal_edges`) over the traced
batches: the share of the padded edge list that K4's plan keeps."""
from port_bench import spans


def read(m):
    return spans.ratio("serve.edges_valid", "serve.edge_slots")
