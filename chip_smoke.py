"""Smoke run of the PyTorch + CUDA port (swarm_ode_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):
  1. the card: CUDA present, name and power limit from nvidia-smi; TF32 off
     for matrix products and cuDNN (the GDE compares the card with the CPU
     in full float32);
  2. build the CUDA kernels from csrc/ (one nvcc per source, in parallel;
     timed);
  3. K1 and K2 against their plain PyTorch version on the card, on real
     medium env rows and random grids: 0 mismatches required; kernel and
     plain times at the main path's shape (12,672 rows);
  4. K3 (full-field BFS) against its plain version on all 57,344 rows of
     real medium states and on random grids: 0 mismatches; its field read
     at each own cell equals K1's (distance, next hop); times at 57,344
     rows;
  5. the card against the CPU: 50 steps of dispatcher + step at B = 64 with
     the same injected draws, every state field, reward and info identical;
  6. the main path: medium, B = 2048, reset + 200 steps, once in each
     setting of bfs_kernel with the launch counts zeroed before and read
     after: the default (bitpack32) launches the bit-packed kernel once per
     step, "int32" the int32 kernel, neither the other's, and nothing
     overflows the compaction; batched_env_steps_per_sec (default setting,
     best of 3 after a warm-up); both settings give identical states from
     one start state and one set of draws;
  7. the full-field rollout: medium, B = 2048, 200 steps with
     bfs_backend="xla", counts zeroed before and read after: K3 once per
     step, K1 and K2 never; steps/s (best of 3); at B = 64 over 50 steps it
     gives states identical to the compacted path, both at
     replan_row_frac = 1.0;
  8. GDE serving: a medium heuristic rollout of B = 512 envs; every step
     observe (partial, D = 435) -> push_frame -> the server
     (build_temporal_batch, temporal_edges, apply_batched with euler over
     t = 0..4 on seeded flagship-shaped weights, newest frame's positions);
     counts zeroed before the 50 counted steps and read after (K4 three
     times per ODE step, one plan per batch); windows/s and ms per batch.
     K4 at D = 435 and 64 on the served edges, planned (the served form:
     sources read through the plan, mean) and general (segment_sum_call):
     against its plain version on the card within the bucket tolerance and
     on the CPU (max error printed), two launches bit-identical, one plan
     and one planned launch with host synchronisation forbidden; times of
     K4, its plain version, the plan and the library yardsticks
     (torch.sparse.mm of the CSR adjacency, index_add_ over the valid rows),
     the bound and the roofline share. The sparse mean against the dense
     one on the card, and the card against the CPU on 8 windows;
  9. 30 medium episodes of 500 steps: mean deliveries within 10% of the
     JAX package's 85.13.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. A kernel's `bound_ms` is the least time the
card could take for its work at this run's inputs: the larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
operations over 67 T/s (float32 outside the tensor cores; the BFS kernels'
integer operations are counted at that rate too), the H100 SXM data sheet's
rates at 700 W.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

MEDIUM = "tarware-medium-19agvs-9pickers-partialobs-v1"
BATCH, STEPS = 2048, 200
# GDE serving: the flagship's shape (results_data/gde_medium_h4w.stablehlo.json).
GDE_BATCH, GDE_STEPS, WINDOW, HORIZON, HIDDEN = 512, 50, 5, 4, 64
# Float32 rounding bound of a sum of up to 32 terms in any order, relative to
# the sum of the terms' magnitudes: 32 * 2**-23. Atomics (K4) and matrix
# products sum in other orders than the plain versions.
SUM_RTOL = 32 * 2.0**-23
# H100 SXM data sheet (700 W): device memory rate, float32 rate outside the
# tensor cores.
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for `nbytes` moved and `ops`
    done, at the card's published peaks."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bfs_bound(pas, out_bytes_per_row: int):
    """Bound of a BFS kernel on K rows of masks `pas` (one byte a cell): the
    masks, target and position in, `out_bytes_per_row` out; a BFS visits each
    cell once (four neighbour reads and an add: 5 operations)."""
    K = pas.shape[0]
    return bound(pas.numel() + K * (8 + out_bytes_per_row), 5 * pas.numel())


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
    layout_cache["state"] = state
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
    times["bound"] = bfs_bound(pas, 8)
    say("kernels", f"times at K={K} rows, n={pas.shape[1]}, {iters} sweeps: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items() if k != "bound")
        + f"; bound {times['bound'][0]:.4f} ms ({times['bound'][1]})")
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


def random_fields(H, W, K, seed, device):
    """Random (K, H, W) grids with targets on every edge and corner, one
    target on a blocked cell (it still starts at 0)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    pas = torch.rand(K, H, W, generator=g) < 0.75
    ty, tx = torch.randint(0, H, (K,), generator=g), torch.randint(0, W, (K,), generator=g)
    ty[0::5], tx[1::5], ty[2::5], tx[3::5] = 0, 0, H - 1, W - 1
    pas[torch.arange(K), ty, tx] = True
    pas[4, ty[4], tx[4]] = False
    return pas.to(device), (ty * W + tx).int().to(device)


def phase_fields(layout_cache):
    import torch

    from swarm_ode_tpu_torch.env import pathfinding
    from swarm_ode_tpu_torch.env.state import agent_class
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas

    _, _, pp = layout_cache["medium"]
    state = layout_cache["state"]
    H, W, iters = pp.grid_h, pp.grid_w, pp.dynamic_bfs_iters
    B, A = state.agent_dir.shape
    xy = state.agent_xy
    occ = torch.zeros(B, H * W, dtype=torch.bool, device=xy.device)
    occ.scatter_(1, (xy[..., 1] * W + xy[..., 0]).long(), True)
    tgt = pp.action_cells[(state.agent_target - 1).clamp(min=0).long()]
    self_yx = xy.flip(-1)
    pas = pathfinding.passable_grid(pp, occ.view(B, H, W), tgt, self_yx, agent_class(pp))
    pas = pas.reshape(B * A, H, W).contiguous()
    tflat = (tgt[..., 0] * W + tgt[..., 1]).to(torch.int32).reshape(-1).contiguous()
    cases = [("medium env rows", pas, tflat, iters),
             ("medium random", *random_fields(H, W, 8192, 12, "cuda"), iters),
             ("medium random, 8 sweeps", *random_fields(H, W, 4096, 13, "cuda"), 8),
             ("80x30 random", *random_fields(80, 30, 1024, 14, "cuda"), 64)]
    max_err = 0
    for name, p, t, it in cases:
        ref = bfs_pallas.bfs_dist_plain(p, t, it)
        got = bfs_pallas.bfs_dist_call(p, t, it)
        torch.cuda.synchronize()
        mism = int((got != ref).sum())
        max_err = max(max_err, int((got.long() - ref.long()).abs().max()))
        say("fields", f"K3 {name}: {p.shape[0]} rows of {p.shape[1]}x{p.shape[2]}, "
            f"reached {float((ref < bfs_pallas.INF).float().mean()):.3f}, mismatches {mism}")
        if mism:
            fail("fields", f"K3 {name}: {mism} mismatches")

    # The full field read at each own cell equals K1's own-cell query.
    dist = bfs_pallas.bfs_dist_call(pas, tflat, iters).view(B, A, H, W)
    d3, nd3 = pathfinding.dist_nextdir_at(pp, dist, pas.view(B, A, H, W), self_yx)
    d1, nd1 = bfs_bitpack.bitpack_query_call(*real_rows(pp, state), H, W, iters)
    torch.cuda.synchronize()
    mism = int(((d3.reshape(-1) != d1) | (nd3.reshape(-1) != nd1)).sum())
    say("fields", f"K3 field at the own cell vs K1 on the same {B * A} rows: mismatches {mism}")
    if mism:
        fail("fields", f"K3 own-cell read differs from K1 on {mism} rows")

    times = {
        "K3": cuda_time_ms(lambda: bfs_pallas.bfs_dist_call(pas, tflat, iters), 20),
        "plain": cuda_time_ms(lambda: bfs_pallas.bfs_dist_plain(pas, tflat, iters), 5),
    }
    # In: the masks (one byte a cell) and the target; out: the int32 field.
    times["bound"] = bound(pas.numel() + 4 * B * A + 4 * pas.numel(), 5 * pas.numel())
    say("fields", f"times at {B * A} rows, {H}x{W}, {iters} sweeps: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items() if k != "bound")
        + f"; bound {times['bound'][0]:.4f} ms ({times['bound'][1]})")
    return times, max_err


def phase_full_field(layout_cache):
    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.state import make_params
    from swarm_ode_tpu_torch.ops import bfs_bitpack, bfs_pallas
    from swarm_ode_tpu_torch.policies.heuristic import heuristic_rollout

    cfg, lay, _ = layout_cache["medium"]
    ppx = make_params(dataclasses.replace(cfg, bfs_backend="xla"), lay, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)

    def timed():
        t0 = time.perf_counter()
        out = heuristic_rollout(ppx, lay, BATCH, STEPS, gen)
        torch.cuda.synchronize()
        if int(out.replan_overflow.sum()):
            fail("full-field", "replan_overflow is not 0 on the full-field branch")
        return BATCH * STEPS / (time.perf_counter() - t0), float(out.deliveries.float().mean())

    heuristic_rollout(ppx, lay, BATCH, 20, gen)  # warm-up
    torch.cuda.synchronize()
    bfs_pallas.DIST_LAUNCHES = bfs_pallas.LAUNCHES = bfs_bitpack.LAUNCHES = 0
    runs = [timed()]
    launches = {"K1": bfs_bitpack.LAUNCHES, "K2": bfs_pallas.LAUNCHES,
                "K3": bfs_pallas.DIST_LAUNCHES}
    if launches != {"K1": 0, "K2": 0, "K3": STEPS}:
        fail("full-field", f"launch counts {launches}, expected K3 {STEPS} and no other")
    runs += [timed() for _ in range(2)]
    say("full-field", f"medium B={BATCH}, {STEPS} steps, bfs_backend=xla, launches {launches}; "
        "runs (steps/s, deliveries per env): "
        + ", ".join(f"({r:.1f}, {d:.3f})" for r, d in runs))
    say("full-field", f"full_field_env_steps_per_sec {max(r for r, _ in runs):.1f}")

    # Without compaction both branches run every row: identical rollouts.
    full = make_params(dataclasses.replace(cfg, bfs_backend="xla", replan_row_frac=1.0), lay, "cuda")
    comp = make_params(dataclasses.replace(cfg, replan_row_frac=1.0), lay, "cuda")
    B, T = 64, 50
    g = torch.Generator(device="cuda").manual_seed(6)
    start = step_mod.reset(full, B, g)
    noise = [step_mod.draw_noise(full, B, g) for _ in range(T)]
    a = heuristic_rollout(full, lay, B, T, state=start, noise=noise, record=True)
    b = heuristic_rollout(comp, lay, B, T, state=start, noise=noise, record=True)
    torch.cuda.synchronize()
    for t, (sa, sb) in enumerate(zip(a.trace, b.trace)):
        if not (_states_equal(sa[3], sb[3]) and torch_equal(sa[0], sb[0])):
            fail("full-field", f"full-field and compacted rollouts differ at step {t}")
    say("full-field", f"B={B}, {T} steps at replan_row_frac=1.0: full-field and compacted "
        f"states identical on every step ({int(a.deliveries.sum())} deliveries, "
        f"{int(a.clashes.sum())} clashes)")
    return launches["K3"]


def _bounded_err(got, ref, abs_sum):
    """(max |got - ref|, whether every element is within SUM_RTOL of its
    sum of magnitudes, plus 1e-6)."""
    err = (got - ref).abs()
    return float(err.max()), bool((err <= SUM_RTOL * abs_sum + 1e-6).all())


def check_k4(feats, src, dst, valid, S, smi):
    """K4 on the served edges at one width D, planned (the served form: the
    sources read through the plan, mean) and general (segment_sum_call on
    the gathered messages): against the plain versions, twice for the same
    bits, with host synchronisation forbidden for one plan and one planned
    launch; times and bounds. Returns the record's numbers."""
    import torch

    from swarm_ode_tpu_torch.ops import segment_pallas as sp

    D = feats.shape[1]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = sp.segment_plan(dst, valid, S, rows=src)
        got = sp.segment_sum_planned(feats, *plan, mean=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    again = sp.segment_sum_planned(feats, *plan, mean=True)
    ref = sp.segment_sum_planned_plain(feats, *plan, mean=True)
    abs_ref = sp.segment_sum_planned_plain(feats.abs(), *plan, mean=True)
    err, ok = _bounded_err(got, ref, abs_ref)
    cpu_err = float((got.cpu() - sp.segment_sum_planned_plain(
        feats.cpu(), *(t.cpu() for t in plan), mean=True)).abs().max())

    keep = valid & (dst >= 0) & (dst < S)
    msgs = feats[src.long()]
    gen = sp.segment_sum_call(msgs, dst, S, valid)
    gen_again = sp.segment_sum_call(msgs, dst, S, valid)
    gen_ref = sp.segment_sum_plain(msgs, dst, S, valid)
    gen_err, gen_ok = _bounded_err(gen, gen_ref, sp.segment_sum_plain(msgs.abs(), dst, S, valid))
    same = torch.equal(got, again) and torch.equal(gen, gen_again)
    torch.cuda.synchronize()

    # Library yardsticks, never called by the port: the served mean as a CSR
    # sparse-dense product, the segment sum as index_add_ over valid rows.
    row, offsets = plan
    M = int(offsets[-1])
    counts = offsets.diff()
    vals = (1.0 / counts.clamp(min=1).float()).repeat_interleave(counts.long(), output_size=M)
    adj = torch.sparse_csr_tensor(offsets.long(), row[:M].long(), vals, size=(S, feats.shape[0]),
                                  check_invariants=True)
    lib_err = float((torch.sparse.mm(adj, feats) - ref).abs().max())
    sel = keep.nonzero()[:, 0]
    dv, mv = dst[sel].long(), msgs[sel].contiguous()
    t = {
        "ms": cuda_time_ms(lambda: sp.segment_sum_planned(feats, *plan, mean=True), 50),
        "plain_ms": cuda_time_ms(lambda: sp.segment_sum_planned_plain(feats, *plan, mean=True), 10),
        "plan_ms": cuda_time_ms(lambda: sp.segment_plan(dst, valid, S, rows=src), 50),
        "library_ms": cuda_time_ms(lambda: torch.sparse.mm(adj, feats), 50),
        "general_ms": cuda_time_ms(lambda: sp.segment_sum_call(msgs, dst, S, valid), 20),
        "general_plain_ms": cuda_time_ms(lambda: sp.segment_sum_plain(msgs, dst, S, valid), 10),
        "general_library_ms": cuda_time_ms(
            lambda: torch.zeros(S, D, device=feats.device).index_add_(0, dv, mv), 20),
    }
    # Planned: each distinct source row read once, the plan, the output;
    # an add per (edge, feature) and a division per output element.
    distinct = int(torch.unique(row[:M]).numel())
    t["bound_ms"], t["bound_by"] = bound(4 * (distinct * D + M + S + 1 + S * D), M * D + S * D)
    # General: the valid messages, every id and flag, the output; the adds.
    E = dst.shape[0]
    t["general_bound_ms"], _ = bound(4 * M * D + 5 * E + 4 * S * D, M * D)
    t.update(max_abs_err=max(err, gen_err), cpu_err=cpu_err, lib_err=lib_err)
    say("gde", f"K4 at D={D}: {E} edge slots ({M} valid, {distinct} distinct sources) into {S} "
        f"nodes. Planned mean vs plain: max abs err {err:.3e}, vs the plain version on the CPU "
        f"{cpu_err:.3e} (the design predicts 0); general sum vs plain {gen_err:.3e} (tolerance "
        f"{SUM_RTOL:.2e} x sum of |terms| + 1e-6); two launches bit-identical: {same}; plan and "
        f"planned launch with host sync forbidden: passed")
    say("gde", f"K4 at D={D} times: planned {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, plan "
        f"{t['plan_ms']:.4f}, torch.sparse.mm {t['library_ms']:.4f}, max abs err {lib_err:.3e}); "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), roofline share "
        f"{t['bound_ms'] / t['ms']:.3f}; general {t['general_ms']:.4f} ms (plain "
        f"{t['general_plain_ms']:.4f}, index_add_ {t['general_library_ms']:.4f}, bound "
        f"{t['general_bound_ms']:.4f}); on {smi}")
    if not (ok and gen_ok):
        fail("gde", f"K4 at D={D} is outside the tolerance (planned {ok}, general {gen_ok})")
    if not same:
        fail("gde", f"K4 at D={D}: two launches on the same inputs differ")
    return t


def phase_gde(layout_cache, smi):
    import copy

    import torch

    from swarm_ode_tpu_torch.env import step as step_mod
    from swarm_ode_tpu_torch.env.observations import observe
    from swarm_ode_tpu_torch.graphs import temporal
    from swarm_ode_tpu_torch.models.gde import GraphODE
    from swarm_ode_tpu_torch.ops import segment, segment_pallas
    from swarm_ode_tpu_torch.ops.sage import masked_mean_aggregate
    from swarm_ode_tpu_torch.policies.heuristic import init_state, make_policy
    from swarm_ode_tpu_torch.serving import make_gde_fn

    _, lay, pp = layout_cache["medium"]
    A = pp.num_agents
    torch.manual_seed(0)
    model_cpu = GraphODE(435, pp.num_agvs, pp.num_pickers, HIDDEN, "euler")
    model = copy.deepcopy(model_cpu).cuda()
    predict = make_gde_fn(model, None, 5.0, HORIZON)
    predict_cpu = make_gde_fn(model_cpu, None, 5.0, HORIZON)
    policy = make_policy(pp, lay)
    gen = torch.Generator(device="cuda").manual_seed(8)
    es = step_mod.reset(pp, GDE_BATCH, gen)
    h = init_state(pp, GDE_BATCH)
    w = temporal.init_window(GDE_BATCH, WINDOW, A, 435, device="cuda")

    def env_step(es, h):
        actions, h = policy(pp, es, h)
        es, _, _, _ = step_mod.step(pp, es, actions, generator=gen)
        return es, h

    def serve(es, w):
        w = temporal.push_frame(w, observe(pp, es))
        return w, predict(w.obs, w.count)

    for _ in range(WINDOW + 2):  # warm-up: fills every window
        es, h = env_step(es, h)
        w, pred = serve(es, w)
    torch.cuda.synchronize()
    segment_pallas.LAUNCHES = 0
    ms = []
    for _ in range(GDE_STEPS):
        es, h = env_step(es, h)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w, pred = serve(es, w)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    launches = segment_pallas.LAUNCHES
    # Per batch one plan, then one K4 launch for each of the 3 SAGE layers in
    # each ODE step.
    expect = GDE_STEPS * HORIZON * 3
    if launches != expect:
        fail("gde", f"K4 launched {launches} times, expected {expect}")
    if pred.shape != (GDE_BATCH, HORIZON + 1, A, 2) or not bool(torch.isfinite(pred).all()):
        fail("gde", f"predictions of shape {tuple(pred.shape)}, finite {bool(torch.isfinite(pred).all())}")
    mean_ms = sum(ms) / len(ms)
    say("gde", f"medium B={GDE_BATCH} windows of {WINDOW}x{A}x435, euler t=0..{HORIZON}, "
        f"{GDE_STEPS} served steps, K4 launches {launches}: ms per batch mean {mean_ms:.3f}, "
        f"min {min(ms):.3f}, max {max(ms):.3f}; gde_windows_per_sec {GDE_BATCH / mean_ms * 1e3:.1f}")

    g = temporal.build_temporal_batch(w.obs, w.count, pp.num_agvs, 5.0)
    src, dst, valid = temporal.temporal_edges(g)
    S = GDE_BATCH * WINDOW * A
    x = w.obs.reshape(S, 435)
    with torch.no_grad():
        hid = torch.relu(model.func.conv1.DenseSAGEConv_0.lin_r(x)).contiguous()
    k4 = {D: check_k4(feats, src, dst, valid, S, smi) for D, feats in ((435, x), (HIDDEN, hid))}

    # The sparse mean (K4) against the dense one on the same graphs.
    dense_g = temporal.build_temporal_graph(w, pp.num_agvs, 5.0)
    dense = masked_mean_aggregate(dense_g.x, dense_g.adj, dense_g.node_mask).reshape(S, 435)
    abs_mean = masked_mean_aggregate(dense_g.x.abs(), dense_g.adj, dense_g.node_mask).reshape(S, 435)
    sparse = segment.gather_scatter_mean(x, src, dst, valid, S)
    err, ok = _bounded_err(sparse, dense, abs_mean)
    say("gde", f"gather_scatter_mean (K4) vs dense masked_mean_aggregate on the card: "
        f"max abs err {err:.3e}")
    if not ok:
        fail("gde", "sparse and dense means differ beyond the tolerance")

    # The card against the CPU on 8 windows, TF32 off.
    got = predict(w.obs[:8], w.count[:8]).cpu()
    ref = predict_cpu(w.obs[:8].cpu(), w.count[:8].cpu())
    err = float((got - ref).abs().max())
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    say("gde", f"card vs CPU, 8 windows: max abs err {err:.3e} on predictions up to "
        f"{float(ref.abs().max()):.2f} (tolerance {tol:.2e}: 1e-4 of the largest)")
    if not err <= tol:
        fail("gde", "card and CPU predictions differ beyond the tolerance")
    return launches, k4


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
    # Full float32 in matrix products and cuDNN: the GDE phase holds the
    # card to the CPU.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    layouts = {}
    times, max_err = phase_kernels(layouts)
    k3_times, k3_err = phase_fields(layouts)
    phase_card_vs_cpu(layouts)
    by_setting = phase_main_path(layouts)
    k3_launches = phase_full_field(layouts)
    k4_launches, k4 = phase_gde(layouts, smi)
    phase_distribution(layouts)
    say("done", f"all phases passed in {time.perf_counter() - t_start:.1f} s on {smi}")

    def entry(k, name, source, replaces, setting):
        # `launches`: the counted main-path run (both settings); the other
        # setting launched this kernel 0 times, as launches_by_setting shows.
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(c[k] for c in by_setting.values()),
                "bfs_kernel_setting": setting,
                "launches_by_setting": {s: c[k] for s, c in by_setting.items()},
                "max_abs_err": max_err[k], "ms": times[k], "plain_ms": times["plain"],
                "bound_ms": times["bound"][0], "bound_by": times["bound"][1], "library_ms": None}

    planned, narrow = k4[435], k4[HIDDEN]
    record = {"kernels": [
        entry("K1", "bitpack_query (K1)", "swarm_ode_tpu_torch/csrc/bfs_bitpack.cu",
              "swarm_ode_tpu/ops/bfs_bitpack.py:75", "bitpack32 (default)"),
        entry("K2", "bfs_query_int32 (K2)", "swarm_ode_tpu_torch/csrc/bfs_query.cu",
              "swarm_ode_tpu/ops/bfs_pallas.py:79", "int32"),
        # `launches`: the counted full-field rollout (bfs_backend="xla").
        {"name": "bfs_dist (K3)", "route": "cuda", "source": "swarm_ode_tpu_torch/csrc/bfs_dist.cu",
         "replaces": "swarm_ode_tpu/ops/bfs_pallas.py:69", "launches": k3_launches,
         "path": "full-field rollout, bfs_backend=xla", "max_abs_err": k3_err,
         "ms": k3_times["K3"], "plain_ms": k3_times["plain"], "bound_ms": k3_times["bound"][0],
         "bound_by": k3_times["bound"][1], "library_ms": None},
        # `launches`: the counted GDE serving run. Times of the served form
        # (planned, mean) at D = 435, the observation width; library_ms is
        # torch.sparse.mm of the CSR adjacency. D = 64 and the general form
        # (segment_sum_call, plan included; index_add_ its yardstick) beside.
        {"name": "segment_sum (K4)", "route": "cuda",
         "source": "swarm_ode_tpu_torch/csrc/segment_sum.cu",
         "replaces": "swarm_ode_tpu/ops/segment_pallas.py:25", "launches": k4_launches,
         "path": "GDE serving", "max_abs_err": max(planned["max_abs_err"], narrow["max_abs_err"]),
         "ms": planned["ms"], "plain_ms": planned["plain_ms"], "bound_ms": planned["bound_ms"],
         "bound_by": planned["bound_by"], "library_ms": planned["library_ms"],
         "plan_ms": planned["plan_ms"],
         "d64": {k: narrow[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "plan_ms")},
         "general": {D: {k[len("general_"):]: k4[D][k] for k in
                         ("general_ms", "general_plain_ms", "general_bound_ms",
                          "general_library_ms")} for D in k4}},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
