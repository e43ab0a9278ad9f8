"""The training step's model FLOPs per second over the float32 peak (67
TFLOP/s, TF32 off as the configuration states), in %: three forwards'
FLOPs of a window (port_bench/counts.gde_window_flops, from the
configuration's shapes) times the measured `train_windows_per_s`."""
from port_bench import counts


def read(m):
    rate = m.end_to_end.get("train_windows_per_s")
    if not rate:
        return None
    g = m.config["gde"]
    flops = counts.gde_window_flops(g["node_dim"], g["hidden_dim"], g["seq_len"],
                                    m.config["num_agvs"] + m.config["num_pickers"],
                                    int(m.traffic["horizon"]))
    return 100.0 * counts.TRAIN_FLOPS_FACTOR * flops * rate / counts.F32_FLOPS_PER_S
