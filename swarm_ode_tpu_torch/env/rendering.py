"""Matplotlib renderer (replaces the reference's pyglet Viewer,
rendering.py:92-349, per SURVEY.md §7 step 9).

Visual language matches the reference: grid lines, goal squares, shelves
(teal when requested), agents (circle = AGV, diamond = Picker; red when
loaded), and a direction tick.

A copy of `swarm_ode_tpu/env/rendering.py` (numpy and matplotlib) that reads
one env of the port's batched state back to the host (`index`, default 0).
matplotlib is imported at the first render, never at import.
"""
from __future__ import annotations

import numpy as np

from swarm_ode_tpu_torch.definitions import AgentType, Direction

_BG = (1.0, 1.0, 1.0)
_GOAL = (0.24, 0.24, 0.24)
_SHELF = (0.35, 0.35, 0.35)
_SHELF_REQ = (0.0, 0.6, 0.6)
_AGV = (0.1, 0.3, 0.9)
_PICKER = (0.9, 0.6, 0.1)
_LOADED = (0.9, 0.1, 0.1)

_DIR_DXY = {
    int(Direction.UP): (0, -1),
    int(Direction.DOWN): (0, 1),
    int(Direction.LEFT): (-1, 0),
    int(Direction.RIGHT): (1, 0),
}


def _host(t, index=None):
    a = t.detach().cpu().numpy()
    return a if index is None else a[index]


def render_state(params, layout, state, mode: str = "rgb_array", index: int = 0):
    import matplotlib

    if mode != "human":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib import patches

    H, W = layout.grid_size
    fig, ax = plt.subplots(figsize=(W / 3, H / 3))
    ax.set_xlim(-0.5, W - 0.5)
    ax.set_ylim(H - 0.5, -0.5)
    ax.set_aspect("equal")
    ax.set_xticks([])
    ax.set_yticks([])

    for (y, x) in layout.goals_yx:
        ax.add_patch(patches.Rectangle((x - 0.5, y - 0.5), 1, 1, color=_GOAL))

    # Shelves: requested ones teal.
    sxy = _host(state.shelf_xy, index)
    carried = set(int(c) for c in _host(state.agent_carrying, index) if c > 0)
    rq = set(int(s) for s in _host(state.request_queue, index))
    for sid in range(1, params.num_shelves + 1):
        if sid in carried:
            continue
        x, y = sxy[sid - 1]
        color = _SHELF_REQ if sid in rq else _SHELF
        ax.add_patch(
            patches.Rectangle((x - 0.45, y - 0.45), 0.9, 0.9, color=color, alpha=0.7)
        )

    axy = _host(state.agent_xy, index)
    adir = _host(state.agent_dir, index)
    acar = _host(state.agent_carrying, index)
    atype = _host(params.agent_type)
    for i in range(params.num_agents):
        x, y = axy[i]
        loaded = acar[i] > 0
        color = _LOADED if loaded else (_PICKER if atype[i] == AgentType.PICKER else _AGV)
        if atype[i] == AgentType.PICKER:
            marker = patches.RegularPolygon((x, y), 4, radius=0.4, color=color)
        else:
            marker = patches.Circle((x, y), 0.35, color=color)
        ax.add_patch(marker)
        dx, dy = _DIR_DXY[int(adir[i])]
        ax.plot([x, x + 0.4 * dx], [y, y + 0.4 * dy], color="black", lw=1.5)

    ax.set_xticks(np.arange(-0.5, W, 1), minor=True)
    ax.set_yticks(np.arange(-0.5, H, 1), minor=True)
    ax.grid(which="minor", color=(0.85, 0.85, 0.85), lw=0.5)

    if mode == "human":
        plt.pause(0.01)
        plt.close(fig)
        return None
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3].copy()
    plt.close(fig)
    return buf
