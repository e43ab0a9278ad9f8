"""ODE integration and its gradients (replaces torchdiffeq.odeint, reference
train_gde.py:78-85 and run_gnode.py:134-135).

Counterpart of `swarm_ode_tpu/ops/odeint.py`, on one tensor state:
  * fixed-step euler / midpoint / rk4: one step per consecutive pair of
    requested times, `substeps` substeps each (torchdiffeq's fixed-grid
    semantics, so t = [0, 1] with euler is one Euler step, the reference
    GDE configuration);
  * adaptive dopri5 with the JAX package's tableau, initial step, error
    norm and controller, run as a bounded loop of `max_steps` masked
    iterations per interval. Nothing in the loop reads a value back to the
    host, so a GPU run never waits on it; iterations after the interval's
    end are no-ops. Step-size control is a schedule that gradients do not
    flow through: the initial step and the error norm are detached, as the
    JAX package stops their gradients.
Gradients flow through the solver by autograd (`checkpoint=True`
recomputes each step or interval in the backward pass, as `jax.checkpoint`
does), or, with `odeint_adjoint`, by the continuous adjoint method.
Times and step sizes are float32 tensors, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils.checkpoint import checkpoint as _recompute


def _euler_step(func, t0, dt, y0):
    return y0 + dt * func(t0, y0)


def _midpoint_step(func, t0, dt, y0):
    k1 = func(t0, y0)
    k2 = func(t0 + dt / 2, y0 + dt / 2 * k1)
    return y0 + dt * k2


def _rk4_step(func, t0, dt, y0):
    k1 = func(t0, y0)
    k2 = func(t0 + dt / 2, y0 + dt / 2 * k1)
    k3 = func(t0 + dt / 2, y0 + dt / 2 * k2)
    k4 = func(t0 + dt, y0 + dt * k3)
    return y0 + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


_FIXED_STEPS = {"euler": _euler_step, "midpoint": _midpoint_step, "rk4": _rk4_step}

# Dormand-Prince 5(4) tableau (as the JAX package's).
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
# 5th-order weights (the last A row: FSAL) and the embedded 4th-order ones.
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B_STAR = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def _dopri5_step(func, t0, dt, y0):
    """One Dopri5 step: (y1, err), err the 5th-4th order difference."""
    c = torch.tensor(_DP_C, dtype=y0.dtype, device=y0.device)
    ks = []
    for i in range(7):
        yi = y0
        for j, aij in enumerate(_DP_A[i]):
            yi = yi + dt * aij * ks[j]
        ks.append(func(t0 + c[i] * dt, yi))
    k = torch.stack(ks)
    b = torch.tensor(_DP_B, dtype=y0.dtype, device=y0.device)
    b_err = b - torch.tensor(_DP_B_STAR, dtype=y0.dtype, device=y0.device)
    y1 = y0 + dt * torch.tensordot(b, k, dims=1)
    err = dt * torch.tensordot(b_err, k, dims=1)
    return y1, err


def _rms(x):
    return torch.sqrt(torch.mean(x * x))


def _error_norm(err, y0, y1, rtol, atol):
    scale = atol + rtol * torch.maximum(y0.abs(), y1.abs())
    return _rms(err / scale)


def _initial_step(func, t0, y0, rtol, atol):
    """Hairer's initial step size heuristic (as in torchdiffeq). Both sides of
    every `where` are computed, so each division is guarded where the other
    side is the one selected; selected values are the JAX package's."""
    f0 = func(t0, y0)
    scale = atol + y0.abs() * rtol
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, 1e-6, 0.01 * d0 / torch.where(small, 1.0, d1))
    f1 = func(t0 + h0, y0 + h0 * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    tiny = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1 = torch.where(
        tiny,
        torch.clamp(h0 * 1e-3, min=1e-6),
        (0.01 / torch.where(tiny, 1.0, torch.maximum(d1, d2))) ** (1.0 / 5.0),
    )
    return torch.minimum(100 * h0, h1)


def _dopri5_interval(func, y0, t0, t1, dt0, rtol, atol, max_steps):
    """Integrate from t0 to t1 in at most `max_steps` attempted steps, each
    one a masked iteration (accepted, rejected, or a no-op once done).
    Returns (y(t1), the last step size)."""
    safety, min_factor, max_factor, order = 0.9, 0.2, 10.0, 5.0
    t, y = t0, y0
    dt = torch.clamp(dt0, min=1e-8)
    done = t0 >= t1 - 1e-12
    for _ in range(max_steps):
        h = torch.minimum(dt, t1 - t)
        y1, err = _dopri5_step(func, t, h, y)
        en = _error_norm(err, y, y1, rtol, atol).detach()
        # A non-finite error estimate rejects the step and shrinks dt.
        en = torch.where(torch.isfinite(en), en, torch.inf)
        accept = en <= 1.0
        factor = torch.clamp(
            safety * (1.0 / torch.clamp(en, min=1e-10)) ** (1.0 / order), min_factor, max_factor
        )
        t_next = torch.where(accept, t + h, t)
        y_next = torch.where(accept, y1, y)
        new_dt = dt * factor
        t_next = torch.where(done, t, t_next)
        y = torch.where(done, y, y_next)
        dt = torch.where(done, dt, new_dt)
        done = done | (t_next >= t1 - 1e-12)
        t = t_next
    return y, dt


def odeint(func: Callable, y0: torch.Tensor, t: torch.Tensor, *, method: str = "dopri5",
           rtol: float = 1e-3, atol: float = 1e-4, substeps: int = 1,
           max_steps: int = 64, checkpoint: bool = False) -> torch.Tensor:
    """Integrate dy/dt = func(t, y) at the times `t` (t[0] is the initial
    time). y0: a float tensor of any shape; t: (T,) increasing times.
    Returns (T, *y0.shape), y0 first. `checkpoint`: keep no intermediate of
    a fixed step or a dopri5 interval for the backward pass, recompute it
    there (the gradients are the same)."""
    t = torch.as_tensor(t, dtype=y0.dtype, device=y0.device)
    ys = [y0]
    y = y0
    if method in _FIXED_STEPS:
        stepper = _FIXED_STEPS[method]
        for k in range(t.shape[0] - 1):
            t0, t1 = t[k], t[k + 1]
            dt = (t1 - t0) / substeps
            for i in range(substeps):
                if checkpoint:
                    y = _recompute(stepper, func, t0 + i * dt, dt, y, use_reentrant=False)
                else:
                    y = stepper(func, t0 + i * dt, dt, y)
            ys.append(y)
    elif method == "dopri5":
        dt = _initial_step(func, t[0], y0, rtol, atol).detach()
        for k in range(t.shape[0] - 1):
            args = (func, y, t[k], t[k + 1], dt, rtol, atol, max_steps)
            if checkpoint:
                y, dt = _recompute(_dopri5_interval, *args, use_reentrant=False)
            else:
                y, dt = _dopri5_interval(*args)
            ys.append(y)
    else:
        raise ValueError(f"Unknown method {method!r}")
    return torch.stack(ys)


class _Adjoint(torch.autograd.Function):
    """odeint of func(t, y, params) whose backward pass integrates the
    augmented system (y, a, grad_params), flattened into one state as the
    JAX package ravels its pytree, from t[i] back to t[i-1] with the same
    solver, segment by segment, adding the output's cotangent at each
    requested time to the adjoint a (`backseg` in the JAX package)."""

    @staticmethod
    def forward(ctx, func, t, kw, y0, *params):
        ys = odeint(lambda ti, y: func(ti, y, params), y0, t, **kw)
        ctx.func, ctx.kw = func, kw
        ctx.save_for_backward(t, ys, *params)
        return ys

    @staticmethod
    def backward(ctx, g):
        t, ys, *params = ctx.saved_tensors
        func = ctx.func
        ny, sizes = ys[0].numel(), [p.numel() for p in params]

        def aug_dyn(ti, aug):
            with torch.enable_grad():
                y = aug[:ny].view_as(ys[0]).detach().requires_grad_()
                ps = tuple(p.detach().requires_grad_() for p in params)
                dy = func(ti, y, ps)
                vjp = torch.autograd.grad(dy, (y, *ps), aug[ny:2 * ny].view_as(dy),
                                          allow_unused=True)
            a_dot, *p_dot = (torch.zeros_like(x) if d is None else d for d, x in zip(vjp, (y, *ps)))
            return torch.cat([dy.detach().reshape(-1), -a_dot.reshape(-1),
                              *(-d.reshape(-1) for d in p_dot)])

        def neg_dyn(ti, aug):
            return -aug_dyn(-ti, aug)

        a = torch.zeros(ny, dtype=ys.dtype, device=ys.device)
        gp = torch.zeros(sum(sizes), dtype=ys.dtype, device=ys.device)
        for i in range(t.shape[0] - 1, 0, -1):
            a = a + g[i].reshape(-1)
            aug0 = torch.cat([ys[i].reshape(-1), a, torch.zeros_like(gp)])
            out = odeint(neg_dyn, aug0, torch.stack([-t[i], -t[i - 1]]), **ctx.kw)[-1]
            a, gp = out[ny:2 * ny], gp + out[2 * ny:]
        a = a + g[0].reshape(-1)
        grads = [d.view_as(p) for d, p in zip(gp.split(sizes), params)]
        return (None, None, None, a.view_as(ys[0]), *grads)


def odeint_adjoint(func: Callable, y0: torch.Tensor, t: torch.Tensor,
                   params: Sequence[torch.Tensor], *, method: str = "dopri5", rtol: float = 1e-3,
                   atol: float = 1e-4, substeps: int = 1, max_steps: int = 64) -> torch.Tensor:
    """odeint with O(1)-memory gradients by the continuous adjoint method.
    func(t, y, params) -> dy, `params` a flat tuple of tensors (the JAX
    function's pytree); gradients flow to y0 and params, computed by
    integrating the augmented system backwards in time with the same solver
    instead of differentiating through the solver's steps."""
    t = torch.as_tensor(t, dtype=y0.dtype, device=y0.device)
    kw = dict(method=method, rtol=rtol, atol=atol, substeps=substeps, max_steps=max_steps)
    return _Adjoint.apply(func, t, kw, y0, *params)
