"""What the GDE runners share: the configuration's sizes, the corpus and
weights made from the seed, and the program's model built with them."""
from __future__ import annotations

import dataclasses

import torch

from port_bench import corpus
from port_bench.runners.common import CORPUS, WEIGHTS, check_env
from port_bench.reference.tarware import config as rconfig
from port_bench.reference.tarware import layout as rlayout


@dataclasses.dataclass(frozen=True)
class Sizes:
    num_agvs: int
    num_pickers: int
    obs_dim: int
    hidden: int
    threshold: float
    window: int
    grid_hw: tuple

    @property
    def agents(self) -> int:
        return self.num_agvs + self.num_pickers


def sizes(config: dict) -> Sizes:
    """The GDE's sizes from a configuration file; the grid the corpus walks
    on from the env id's layout."""
    gde = config["gde"]
    env = rconfig.EnvConfig.from_env_id(config["env_id"])
    check_env(config, env)
    lay = rlayout.build_layout(env)
    return Sizes(config["num_agvs"], config["num_pickers"], gde["node_dim"], gde["hidden_dim"],
                 float(gde["distance_threshold"]), gde["seq_len"], tuple(lay.grid_size))


def make_inputs(ctx, sz: Sizes, horizon: int):
    """The corpus and the weights, on the device, from the seed."""
    tr = ctx.traffic
    data = corpus.make_corpus(int(tr["episodes"]), int(tr["episode_steps"]), sz.agents,
                              sz.obs_dim, sz.num_agvs, sz.grid_hw, horizon, float(tr["flag_p"]),
                              corpus.generator(ctx.seed, ctx.device, CORPUS), ctx.device)
    weights = corpus.make_weights(sz.obs_dim, sz.hidden,
                                  corpus.generator(ctx.seed, ctx.device, WEIGHTS), ctx.device)
    return data, weights


def program_model(ctx, sz: Sizes, weights):
    """The program's GraphODE with the benchmark's weights (all of them, by
    the program's own names: a leaf renamed fails here)."""
    from swarm_ode_tpu_torch.models.gde import GraphODE

    model = GraphODE(node_dim=sz.obs_dim, num_agvs=sz.num_agvs, num_pickers=sz.num_pickers,
                     hidden_dim=sz.hidden, ode_solver=ctx.config["gde"]["ode_solver"])
    model.load_state_dict({k: v.clone() for k, v in weights.items()}, strict=True)
    return model.to(ctx.device)


def precision(config: dict, tf32=None) -> None:
    """The configuration's float32 precision on the card (TF32 off unless
    the configuration says otherwise), or TF32 as `tf32` says (the
    control's)."""
    on = bool(config["gde"].get("tf32", False)) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
