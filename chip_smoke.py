"""Smoke run of the PyTorch + CUDA port (swarm_ode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):
  1. the card: CUDA present, name and power limit from nvidia-smi;
  2. build the CUDA kernels from csrc/ (timed);
  3. each kernel against the plain PyTorch version on the card, on real
     medium env rows and random grids: 0 mismatches required; kernel and
     plain times at the main path's shape (12,672 rows);
  4. the card against the CPU: 50 steps of dispatcher + step at B = 64 with
     the same injected draws, every state field, reward and info identical;
  5. the main path: medium, B = 2048, reset + 200 steps, once in each
     setting of bfs_kernel with the launch counts zeroed before and read
     after: the default (bitpack32) launches the bit-packed kernel once per
     step, "int32" the int32 kernel, neither the other's, and nothing
     overflows the compaction; batched_env_steps_per_sec (default setting,
     best of 3 after a warm-up); both settings give identical states from
     one start state and one set of draws;
  6. 30 medium episodes of 500 steps: mean deliveries within 10% of the
     JAX package's 85.13.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
BATCH, STEPS = 2048, 200
# JAX package, 30 medium episodes (results_data/parity_rejoin_r4.json,
# parity_at_chosen): deliveries, clashes, stucks per episode.
JAX_PARITY = {"deliveries": 85.13, "clashes": 189.23, "stucks": 16.63}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"[{phase}] FAILED: {msg}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("card", "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi name, power.limit:")
    print(smi, flush=True)
    return smi


def phase_build():
    from swarm_ode_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    report = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
              if "registers" in ln or "spill" in ln]
    say("build", f"{path.name} in {dt:.1f} s; ptxas: " + " | ".join(report))


def real_rows(pp, state):
    """Every agent's replan query in `state` (all B*A rows, uncompacted)."""
    import torch

    from swarm_ode_tpu_torch.env.pathfinding import walled
    from swarm_ode_tpu_torch.env.state import agent_class
    from swarm_ode_tpu_torch.ops import bfs_pallas

    B, A = state.agent_dir.shape
    H, W = pp.grid_h, pp.grid_w
    Ws = W + 1
    xy = state.agent_xy
    occ = torch.zeros(B, H * W, dtype=torch.bool, device=xy.device)
    occ.scatter_(1, (xy[..., 1] * W + xy[..., 0]).long(), True)
    tgt = pp.action_cells[(state.agent_target - 1).clamp(min=0).long()]
    _, pas, tgtK, posK = bfs_pallas.compact_rows(
        walled(occ.view(B, H, W)), tgt[..., 0] * Ws + tgt[..., 1],
        xy[..., 1] * Ws + xy[..., 0], agent_class(pp),
        torch.ones(B, A, dtype=torch.bool, device=xy.device), walled(pp.picker_passable),
        H, W, row_frac=1.0, rows_per_block=128,
    )
    return pas, tgtK, posK


def random_rows(H, W, K, seed, device):
    """Random grids (ties everywhere) with own cells on edges and corners."""
    import torch

    g = torch.Generator().manual_seed(seed)
    Ws = W + 1
    n = H * Ws
    grid = torch.rand(K, H, W, generator=g) < 0.75
    pas = torch.cat([grid, torch.zeros(K, H, 1, dtype=torch.bool)], 2).reshape(K, n)
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py, px = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    py[0::4] = 0
    px[1::4] = 0
    py[2::4] = H - 1
    px[3::4] = W - 1
    tgt = (ty * Ws + tx).int()
    pos = (py * Ws + px).int()
    col = torch.arange(n)
    pas |= (col == tgt[:, None]) | (col == pos[:, None])
    return pas.to(device), tgt.to(device), pos.to(device)


def phase_kernels(layout_cache):
    import torch

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env.layout import build_layout
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg = EnvConfig.from_env_id(MEDIUM)
    lay = build_layout(cfg)
    pp = make_params(cfg, lay, "cuda")
    layout_cache["medium"] = (cfg, lay, pp)
    H, W, iters = pp.grid_h, pp.grid_w, pp.dynamic_bfs_iters
    gen = torch.Generator(device="cuda").manual_seed(1)
    state = heuristic_rollout(pp, lay, BATCH, 40, gen).state
    cases = [("medium env rows", H, W, iters, *real_rows(pp, state))]
    cases.append(("medium random", H, W, iters, *random_rows(H, W, 8192, 2, "cuda")))
    cases.append(("medium random, 8 sweeps", H, W, 8, *random_rows(H, W, 4096, 3, "cuda")))
    xl = EnvConfig.from_env_id("tarware-extralarge-14agvs-7pickers-partialobs-v1")
    xH, xW = build_layout(xl).grid_size
    cases.append(("extralarge random (45 words)", xH, xW, 40, *random_rows(xH, xW, 4096, 4, "cuda")))
    cases.append(("80x30 random (79 words)", 80, 30, 64, *random_rows(80, 30, 1024, 5, "cuda")))

    rows_checked = 0
    max_err = {"K1": 0, "K2": 0}
    for name, h, w, it, pas, tgt, pos in cases:
        d0, nd0 = bfs_pallas.query_plain(pas, tgt, pos, h, w, it)
        d1, nd1 = bfs_bitpack.bitpack_query_call(pas, tgt, pos, h, w, it)
        d2, nd2 = bfs_pallas.query_call(pas, tgt, pos, h, w, it)
        torch.cuda.synchronize()
        mism = {
            "K1 vs plain": int(((d1 != d0) | (nd1 != nd0)).sum()),
            "K2 vs plain": int(((d2 != d0) | (nd2 != nd0)).sum()),
            "K1 vs K2": int(((d1 != d2) | (nd1 != nd2)).sum()),
        }
        for k, (d, nd) in (("K1", (d1, nd1)), ("K2", (d2, nd2))):
            err = max(int((d - d0).abs().max()), int((nd - nd0).abs().max()))
            max_err[k] = max(max_err[k], err)
        reached = float((d0 < bfs_pallas.INF).float().mean())
        say("kernels", f"{name}: {pas.shape[0]} rows, n={pas.shape[1]}, reached "
            f"{reached:.3f}, mismatches {mism}")
        if any(mism.values()):
            fail("kernels", f"{name}: {mism}")
        rows_checked += pas.shape[0] if name == "medium env rows" else 0
    if rows_checked < 12672:
        fail("kernels", f"only {rows_checked} real main-path rows checked")

    # Times at the main path's shape: the compacted block of 12,672 rows.
    K = bfs_pallas._round_up(int(BATCH * pp.num_agents * pp.replan_row_frac), 128)
    pas, tgt, pos = (t[:K].contiguous() for t in cases[0][4:])
    times = {
        "K1": cuda_time_ms(lambda: bfs_bitpack.bitpack_query_call(pas, tgt, pos, H, W, iters), 200),
        "K2": cuda_time_ms(lambda: bfs_pallas.query_call(pas, tgt, pos, H, W, iters), 50),
        "plain": cuda_time_ms(lambda: bfs_pallas.query_plain(pas, tgt, pos, H, W, iters), 10),
    }
    say("kernels", f"times at K={K} rows, n={pas.shape[1]}, {iters} sweeps: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))
    return times, max_err


def _states_equal(a, b):
    return all(
        torch_equal(getattr(a, f.name), getattr(b, f.name)) for f in dataclasses.fields(a)
    )


def torch_equal(x, y) -> bool:
    import torch

    return x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())


def phase_card_vs_cpu(layout_cache):
    import torch

    from swarm_ode_tpu_torch import convert
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, pp_gpu = layout_cache["medium"]
    pp_cpu = make_params(cfg, lay, "cpu")
    B, T = 64, 50
    g = torch.Generator().manual_seed(5)
    s_cpu = step_mod.reset(pp_cpu, B, g)
    noise_cpu = [step_mod.draw_noise(pp_cpu, B, g) for _ in range(T)]
    noise_gpu = [
        step_mod.StepNoise(None if n.break_r is None else n.break_r.cuda(), n.delivery_gumbel.cuda())
        for n in noise_cpu
    ]
    k1 = bfs_bitpack.LAUNCHES
    t0 = time.perf_counter()
    gpu = heuristic_rollout(pp_gpu, lay, B, T, state=convert.env_state_to(s_cpu, "cuda"),
                            noise=noise_gpu, record=True)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if bfs_bitpack.LAUNCHES - k1 != T:
        fail("card-vs-cpu", f"K1 launched {bfs_bitpack.LAUNCHES - k1} times in {T} steps")
    t0 = time.perf_counter()
    cpu = heuristic_rollout(pp_cpu, lay, B, T, state=s_cpu, noise=noise_cpu, record=True)
    t_cpu = time.perf_counter() - t0
    for t, (g_step, c_step) in enumerate(zip(gpu.trace, cpu.trace)):
        ga, gr, ginfo, gs = g_step
        ca, cr, cinfo, cs = c_step
        same = (torch_equal(ga, ca) and torch_equal(gr, cr) and _states_equal(gs, cs)
                and all(torch_equal(ginfo[k], cinfo[k]) for k in cinfo))
        if not same:
            fail("card-vs-cpu", f"card and CPU differ at step {t}")
    deliv = int(cpu.deliveries.sum())
    say("card-vs-cpu", f"B={B}, {T} steps: states, actions, rewards and info identical on "
        f"every step ({deliv} deliveries, {int(cpu.clashes.sum())} clashes, overflow "
        f"{int(cpu.replan_overflow.sum())}); card {t_gpu:.2f} s, CPU {t_cpu:.2f} s")
    if deliv == 0:
        fail("card-vs-cpu", "no deliveries: the comparison exercised too little")


def phase_main_path(layout_cache):
    import torch

    from swarm_ode_tpu_torch.config import EnvConfig
    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, pp = layout_cache["medium"]
    # bench.py's --bfs_kernel option: the same main path through K2.
    pp32 = make_params(dataclasses.replace(cfg, bfs_kernel="int32"), lay, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def timed(params):
        t0 = time.perf_counter()
        out = heuristic_rollout(params, lay, BATCH, STEPS, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        overflow = int(out.replan_overflow.sum())
        if overflow:
            fail("main-path", f"{params.bfs_kernel}: replan_overflow summed to {overflow}")
        return BATCH * STEPS / dt, float(out.deliveries.float().mean())

    heuristic_rollout(pp, lay, BATCH, STEPS, gen)  # warm-up
    torch.cuda.synchronize()

    # The counted run: the main path once in each kernel setting, default
    # first. Each setting launches its own kernel once per step, the other
    # never.
    bfs_bitpack.LAUNCHES = 0
    bfs_pallas.LAUNCHES = 0
    runs = [timed(pp)]
    by_setting = {"bitpack32": {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES}}
    rate32, deliv32 = timed(pp32)
    launches = {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES}
    by_setting["int32"] = {k: launches[k] - by_setting["bitpack32"][k] for k in launches}
    expect = {"bitpack32": {"K1": STEPS, "K2": 0}, "int32": {"K1": 0, "K2": STEPS}}
    if by_setting != expect:
        fail("main-path", f"launch counts {by_setting}, expected {expect}")
    say("main-path", f"medium B={BATCH}, {STEPS} steps, launches per kernel setting: "
        f"{by_setting}; overflow 0")

    runs += [timed(pp) for _ in range(2)]
    say("main-path", f"bitpack32 runs (steps/s, deliveries per env): "
        + ", ".join(f"({r:.1f}, {d:.3f})" for r, d in runs)
        + f"; int32, one run after the first: ({rate32:.1f}, {deliv32:.3f})")
    say("main-path", f"batched_env_steps_per_sec {max(r for r, _ in runs):.1f}")

    # From one start state and one set of draws both kernels give identical
    # steps (these launches are a comparison and are not counted above).
    g = torch.Generator(device="cuda").manual_seed(9)
    start = heuristic_rollout(pp, lay, BATCH, 30, g).state
    noise = [step_mod.draw_noise(pp, BATCH, g) for _ in range(5)]
    a = heuristic_rollout(pp32, lay, BATCH, 5, state=start, noise=noise)
    b = heuristic_rollout(pp, lay, BATCH, 5, state=start, noise=noise)
    torch.cuda.synchronize()
    if not _states_equal(a.state, b.state):
        fail("main-path", "int32 and bitpack32 rollouts differ")
    say("main-path", f"bfs_kernel=int32 vs bitpack32, B={BATCH}, 5 steps from one state "
        "with the same draws: states identical")
    return by_setting


def phase_distribution(layout_cache):
    import torch

    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    _, lay, pp = layout_cache["medium"]
    gen = torch.Generator(device="cuda").manual_seed(2024)
    out = heuristic_rollout(pp, lay, 30, 500, gen)
    got = {
        "deliveries": float(out.deliveries.float().mean()),
        "clashes": float(out.clashes.float().mean()),
        "stucks": float(out.stucks.float().mean()),
    }
    say("distribution", "30 medium episodes x 500 steps, port vs JAX package: "
        + ", ".join(f"{k} {got[k]:.2f} vs {JAX_PARITY[k]}" for k in got)
        + f"; overflow {int(out.replan_overflow.sum())}")
    lo, hi = 0.9 * JAX_PARITY["deliveries"], 1.1 * JAX_PARITY["deliveries"]
    if not lo <= got["deliveries"] <= hi:
        fail("distribution", f"mean deliveries {got['deliveries']:.2f} outside [{lo:.1f}, {hi:.1f}]")


def main() -> None:
    t_start = time.perf_counter()
    import torch

    smi = phase_card()
    phase_build()
    layouts = {}
    times, max_err = phase_kernels(layouts)
    phase_card_vs_cpu(layouts)
    by_setting = phase_main_path(layouts)
    phase_distribution(layouts)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s on {smi}")

    def entry(k, name, source, replaces, setting):
        # `launches`: the counted main-path run (both settings); the other
        # setting launched this kernel 0 times, as launches_by_setting shows.
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(c[k] for c in by_setting.values()),
                "bfs_kernel_setting": setting,
                "launches_by_setting": {s: c[k] for s, c in by_setting.items()},
                "max_abs_err": max_err[k], "ms": times[k], "plain_ms": times["plain"]}

    record = {"kernels": [
        entry("K1", "bitpack_query (K1)", "swarm_ode_tpu_torch/csrc/bfs_bitpack.cu",
              "swarm_ode_tpu/ops/bfs_bitpack.py:75", "bitpack32 (default)"),
        entry("K2", "bfs_query_int32 (K2)", "swarm_ode_tpu_torch/csrc/bfs_query.cu",
              "swarm_ode_tpu/ops/bfs_pallas.py:79", "int32"),
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
