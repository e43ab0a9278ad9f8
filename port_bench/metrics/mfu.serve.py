"""The served batches' model FLOPs per second over the float32 peak (67
TFLOP/s, TF32 off as the configuration states), in %: a window's forward
FLOPs (port_bench/counts.gde_window_flops, from the configuration's shapes)
times the measured `gde_windows_per_s`."""
from port_bench import counts


def read(m):
    rate = m.end_to_end.get("gde_windows_per_s")
    if not rate:
        return None
    g = m.config["gde"]
    flops = counts.gde_window_flops(g["node_dim"], g["hidden_dim"], g["seq_len"],
                                    m.config["num_agvs"] + m.config["num_pickers"],
                                    int(m.traffic["horizon"]))
    return 100.0 * flops * rate / counts.F32_FLOPS_PER_S
