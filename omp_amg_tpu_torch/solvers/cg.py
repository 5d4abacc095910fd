"""Conjugate gradient solvers (counterpart of ``omp_amg_tpu/solvers/cg.py``:
``pcg``, ``pcg_pipelined``, ``amg_pcg`` and ``cg``).

Each variant is a start step and an iteration step over a device state
(:mod:`.graph`): every scalar, the iteration counter, the exit flag and the
residual history stay on the device. Standard PCG forms α, β and the
residual norm there; the pipelined (single-reduction) PCG forms γ, δ and
‖r‖² at one point per iteration and α, β from them as f32 device scalars,
the IEEE f32 operations of the reference's traced scalars
(``omp_amg_tpu/solvers/cg.py:107-108``), in the order the host loop of
earlier versions computed them in numpy float32, so the iterates are bit
for bit that loop's. Both update their state vectors (x, r, p and, pipelined,
s) in place through :mod:`..ops.pcg_update`, per shard on shard lists.

``amg_pcg`` and ``cg`` run the captured blocks of :mod:`.graph` on CUDA
(``graph=True``, the default: CUDA graphs cached on the hierarchy, or on
the operator for ``cg``), the same steps as an eager block loop on CPU
tensors, and with ``graph=False`` the per-iteration loop (one host read of
the exit flag per iteration). ``pcg`` and ``pcg_pipelined``, which take any
preconditioner callable, run the per-iteration loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..amg.hierarchy import Hierarchy
from ..amg.vcycle import vcycle
from ..ops import pcg_update
from ..ops.spmv import spmv
from ..ops.vecops import dot
from . import graph as G

VARIANTS = ("standard", "pipelined")


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_residual: float      # ‖r_k‖/‖b‖ (recursive residual)
    history: list            # ‖r_k‖ per iteration, k = 0..iters


def host_copy(st: dict, *names) -> tuple:
    """The one host copy at the end: (k, history[0..k], and the named
    scalars as np.float32)."""
    hist = st["hist"]
    packed = torch.cat([hist, torch.stack([st[n] for n in names]),
                        st["k"].to(hist.dtype).view(1)]).cpu().numpy()
    k = int(packed[-1])
    return (k, [float(h) for h in packed[:k + 1]],
            *(np.float32(v) for v in packed[len(hist):-1]))


def standard_program(apply_a, precond: Callable, maxiter: int, *,
                     dot=dot, norm=torch.linalg.vector_norm,
                     vmap=G.vmap) -> G.Program:
    """Standard PCG as start and iteration steps over the products
    ``apply_a`` and ``precond``; ``dot``, ``norm`` and ``vmap`` (per-vector
    maps) are the single-device ones or, sharded, the shard-order ones of
    :mod:`..parallel.dist`. The exit test is the reference's f32
    ‖r‖ > tol·‖b‖.

    The step updates the state's x, r and p in place through
    :mod:`..ops.pcg_update` (the kernel on the card), per shard on shard
    lists, masked by the step's entry flag, so the start gives the state
    buffers of its own."""

    def start(b, tol, x0):
        if x0 is None:
            x, r = vmap(torch.zeros_like, b), vmap(torch.clone, b)
        else:
            x = vmap(torch.clone, x0)
            r = vmap(torch.sub, b, apply_a(x0))
        bnorm = G.guard(norm(b))
        z = precond(r)
        rnorm = norm(r)
        hist, k = G.new_history(maxiter, rnorm)
        thr = tol * bnorm
        return dict(x=x, r=r, p=vmap(torch.clone, z), rz=dot(r, z), k=k,
                    active=(rnorm > thr) & (k < maxiter), hist=hist,
                    thr=thr, bnorm=bnorm)

    def step(st, masked):
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        sel = G.selector(st["active"], masked)
        flag = st["active"] if masked else None
        q = apply_a(p)
        alpha = rz / dot(p, q)
        vmap(lambda *v: pcg_update.xr(*v, alpha, flag), x, r, p, q)
        z = precond(r)
        rz_n = dot(r, z)
        beta = rz_n / rz
        vmap(lambda *v: pcg_update.p_update(*v, beta, flag), p, z)
        rnorm = norm(r)
        k, active = G.advance(st, maxiter, rnorm > st["thr"])
        G.record(st["hist"], k, rnorm, st["active"])
        return dict(st, rz=sel(rz_n, rz), k=k, active=active)

    def finish(st):
        k, history, bnorm = host_copy(st, "bnorm")
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(history[-1] / bnorm),
                        history=history)

    return G.Program(start, step, finish)


def pipelined_program(a, precond: Callable, maxiter: int) -> G.Program:
    """Single-reduction PCG (Chronopoulos–Gear) as start and iteration
    steps: γ = (r, u), δ = (w, u) and ‖r‖² of the updated state at one
    reduction point per iteration, α_k = γ_k / (δ_k − β_k·γ_k/α_{k−1}); the
    exit test is the reference's f32 √‖r‖² > tol·‖b‖ on the updated
    residual."""

    def reduce(r, u, w):
        return torch.stack([dot(r, u), dot(w, u), dot(r, r)]).unbind()

    def start(b, tol, x0):
        if x0 is None:
            x, r = torch.zeros_like(b), b.clone()
        else:
            x, r = x0.clone(), b - spmv(a, x0)
        bnorm = G.guard(torch.linalg.vector_norm(b))
        u = precond(r)
        w = spmv(a, u)
        gamma, delta, rn2 = reduce(r, u, w)
        rnorm = torch.sqrt(rn2)
        hist, k = G.new_history(maxiter, rnorm)
        thr = tol * bnorm
        one = torch.ones_like(rnorm)
        return dict(x=x, r=r, u=u, w=w, p=torch.zeros_like(b),
                    s=torch.zeros_like(b), gamma=gamma, delta=delta,
                    g_prev=one, a_prev=one.clone(), k=k,
                    active=(rnorm > thr) & (k < maxiter), hist=hist,
                    thr=thr, bnorm=bnorm)

    def step(st, masked):
        sel = G.selector(st["active"], masked)
        gamma, delta = st["gamma"], st["delta"]
        beta = torch.where(st["k"] == 0, torch.zeros_like(gamma),
                           gamma / st["g_prev"])
        alpha = gamma / (delta - beta * gamma / st["a_prev"])
        flag = st["active"] if masked else None
        x, r, p, s = st["x"], st["r"], st["p"], st["s"]
        pcg_update.p_update(p, st["u"], beta, flag)
        pcg_update.p_update(s, st["w"], beta, flag)
        pcg_update.xr(x, r, p, s, alpha, flag)
        u = precond(r)
        w = spmv(a, u)
        g_n, d_n, rn2 = reduce(r, u, w)
        rnorm = torch.sqrt(rn2)
        k, active = G.advance(st, maxiter, rnorm > st["thr"])
        G.record(st["hist"], k, rnorm, st["active"])
        return dict(st, u=sel(u, st["u"]), w=sel(w, st["w"]),
                    gamma=sel(g_n, gamma), delta=sel(d_n, delta),
                    g_prev=sel(gamma, st["g_prev"]),
                    a_prev=sel(alpha, st["a_prev"]), k=k, active=active)

    def finish(st):
        k, history, bnorm = host_copy(st, "bnorm")
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(np.float32(history[-1]) / bnorm),
                        history=history)

    return G.Program(start, step, finish)


def pcg(a, b: torch.Tensor, precond: Callable, tol: float = 1e-8,
        maxiter: int = 500, x0=None) -> CGResult:
    """Solve A x = b with preconditioner ``precond`` (M⁻¹ apply, a fixed
    SPD linear operator): the per-iteration loop."""
    return G.run(standard_program(lambda v: spmv(a, v), precond, maxiter),
                 b, tol, x0, graph=False)


def pcg_pipelined(a, b: torch.Tensor, precond: Callable, tol: float = 1e-8,
                  maxiter: int = 500, x0=None) -> CGResult:
    """Single-reduction PCG (:func:`pipelined_program`): the per-iteration
    loop. The same iterates as standard PCG in exact arithmetic."""
    return G.run(pipelined_program(a, precond, maxiter), b, tol, x0,
                 graph=False)


def _key(name, a, b, x0, maxiter):
    return (name, id(a), tuple(b.shape), b.dtype, x0 is None, int(maxiter))


def _form(op) -> tuple:
    """What of an operator or vector decides the code a cycle runs: its
    type, offsets or taps, and value type."""
    if isinstance(op, torch.Tensor):
        return ("tensor", op.dtype, tuple(op.shape))
    if isinstance(op, (int, float)):
        return ("scalar",)
    vals = getattr(op, "data", getattr(op, "vals", None))
    return (type(op).__name__, getattr(op, "offsets", None),
            getattr(op, "taps", None),
            vals.dtype if isinstance(vals, torch.Tensor) else None)


def _path(name, a, hier: Hierarchy, b, x0, maxiter) -> tuple:
    """The code path of a PCG capture on ``hier``: the key without the
    operator's identity, the parameters, and the forms of every level's
    operators and vectors and of the coarse factor."""
    return (name, _form(a), tuple(b.shape), b.dtype, x0 is None,
            int(maxiter), repr(hier.params), _form(hier.coarse_chol),
            tuple(tuple(_form(op) for op in (lv.a, lv.p, lv.r, lv.s,
                                              lv.dinv_dev))
                  for lv in hier.levels))


def _amg_program(a, hier: Hierarchy, maxiter: int, variant: str):
    def precond(r):
        return vcycle(hier, r)

    return (pipelined_program(a, precond, maxiter)
            if variant == "pipelined" else
            standard_program(lambda v: spmv(a, v), precond, maxiter))


def amg_pcg(a, b: torch.Tensor, hier: Hierarchy, tol: float = 1e-8,
            maxiter: int = 500, x0=None, variant: str = "standard",
            graph: bool = True) -> CGResult:
    """PCG with M⁻¹ = one cycle of ``hier``; ``variant="pipelined"`` is the
    single-reduction PCG. ``graph=True``: captured blocks on CUDA, cached on
    ``hier`` (keyed by the operator, shape, dtype, ``maxiter``, variant and
    block size; ``tol`` is an input of the graphs), the eager block loop on
    CPU tensors; ``graph=False``: the per-iteration loop."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r} (supported: "
                         f"{', '.join(VARIANTS)})")
    return G.run(_amg_program(a, hier, maxiter, variant), b, tol, x0,
                 graph=graph, owner=hier,
                 key=_key(variant, a, b, x0, maxiter), keep=(a,),
                 path=lambda: _path(variant, a, hier, b, x0, maxiter))


def recapture(keys, old_a, hier: Hierarchy) -> None:
    """Capture on ``hier`` the PCG graphs of ``keys`` (the captured keys of
    the hierarchy it replaces, whose level-0 operator was ``old_a``) that
    ran on that operator without ``x0``, the graphs of a certified solve,
    on ``hier``'s own level 0: what the next solve would capture. Nothing
    else runs (:func:`.graph.prepare`)."""
    if not hier.levels or hier.device.type != "cuda":
        return
    a = hier.levels[0].a
    for name, a_id, shape, dtype, no_x0, maxiter in keys:
        if a_id != id(old_a) or not no_x0 or name not in VARIANTS:
            continue
        b = torch.zeros(shape, dtype=dtype, device=hier.device)
        G.prepare(_amg_program(a, hier, maxiter, name), b, owner=hier,
                  key=_key(name, a, b, None, maxiter), keep=(a,),
                  path=lambda: _path(name, a, hier, b, None, maxiter))


def cg(a, b: torch.Tensor, tol: float = 1e-8, maxiter: int = 500,
       x0=None, graph: bool = True) -> CGResult:
    """Unpreconditioned CG (the baseline); ``graph`` as in
    :func:`amg_pcg`, the graphs cached on the operator ``a``."""
    return G.run(standard_program(lambda v: spmv(a, v), lambda r: r,
                                  maxiter),
                 b, tol, x0, graph=graph, owner=a,
                 key=_key("cg", a, b, x0, maxiter))
