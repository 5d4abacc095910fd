"""The port's PCG as start and iteration steps (``solvers/graph.py``), on
the CPU, where ``graph=True`` runs the captured blocks' steps as an eager
block loop:

- blocks of K ∈ {1, 3, 8} masked steps give the per-iteration loop's
  (``graph=False``) iteration count, history and x bit for bit: standard,
  pipelined and unpreconditioned CG on one device, standard and pipelined
  on 1, 2 and 4 shards;
- the per-iteration loop gives, bit for bit, the loop that read its norms
  and (pipelined) γ, δ and ‖r‖² to the host and formed α and β there in
  numpy float32: the loops of earlier versions, kept here as oracles;
- the reference's ``amg_pcg`` on its own hierarchy and the port's on the
  same hierarchy carried over (``hierarchy_from_numpy``) take the same
  number of iterations;
- ``maxiter`` reached inside a block stops the count there; b = 0 takes no
  iteration;
- every PCG program, whose vectors the step updates in place
  (``ops/pcg_update.py``), gives bit for bit the where-form step of earlier
  versions (kept here as oracles), on both loops: standard PCG, ``cg`` and
  pipelined PCG on one device, from x = 0 and from a given x0, and
  standard and pipelined PCG on 2 and 4 shards; the caller's x0, and its b
  (full or in shards) on the sharded path, are left as they were;
- a refresh drops the graphs cached on the hierarchy it replaces.

The capture itself needs the card: ``tests/test_torch_cuda.py``.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_setup
from omp_amg_tpu.amg.params import AMGParams as RefParams
from omp_amg_tpu.solvers.cg import amg_pcg as ref_amg_pcg

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.ops.spmv import spmv
from omp_amg_tpu_torch.parallel.dist import (
    _pdots, dist_spmv, dist_vcycle, make_dist_solver, pdot, pnorm,
)
from omp_amg_tpu_torch.solvers import graph as G
from omp_amg_tpu_torch.solvers.cg import CGResult, host_copy

torch.set_num_threads(2)

PMIS = port.AMGParams(coarsening="pmis")
N_SERIAL = 12
N_SHARDED = 16
AGG = 64          # 16³ on 4 shards: L0 halo, L1 gather, L2 replicated
TOL = 1e-6


@pytest.fixture(scope="module")
def serial():
    a = port.poisson3d_7pt(N_SERIAL)
    hier = port.amg_setup(a, PMIS, device="cpu")
    return hier, port.default_rhs(a, seed=0)


_MESHES = {}


def _mesh(ndev):
    if ndev not in _MESHES:
        a = port.poisson3d_7pt(N_SHARDED)
        mesh = port.ShardMesh(ndev, "cpu")
        dh = port.dist_pmis_setup(a, ndev, PMIS, mesh=mesh,
                                  agg_rows_per_dev=AGG, transport="remote")
        _MESHES[ndev] = (mesh, dh, mesh.shard(port.default_rhs(a, seed=0)))
    return _MESHES[ndev]


def _same(r0, r1):
    assert r1.iters == r0.iters
    assert r1.history == r0.history
    assert r1.rel_residual == r0.rel_residual
    xs0 = r0.x if isinstance(r0.x, list) else [r0.x]
    xs1 = r1.x if isinstance(r1.x, list) else [r1.x]
    assert all(torch.equal(u, v) for u, v in zip(xs0, xs1))


def _serial_solve(variant, hier, b, **kw):
    a = hier.levels[0].a
    if variant == "cg":
        return port.cg(a, b, tol=TOL, **kw)
    return port.amg_pcg(a, b, hier, tol=TOL, variant=variant, **kw)


# --- the loops of earlier versions, host scalars (oracles) ------------------

def _host_pcg(a, b, precond, tol, maxiter):
    x, r = torch.zeros_like(b), b.clone()
    bnorm = np.float32(torch.linalg.vector_norm(b).item())
    bnorm = np.float32(1.0) if bnorm == 0 else bnorm
    threshold = float(np.float32(tol) * bnorm)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    rnorm = torch.linalg.vector_norm(r).item()
    history = [rnorm]
    k = 0
    while rnorm > threshold and k < maxiter:
        q = spmv(a, p)
        alpha = rz / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rnorm = torch.linalg.vector_norm(r).item()
        history.append(rnorm)
    return x, k, float(rnorm / bnorm), history


def _host_pcg_pipelined(a, b, precond, tol, maxiter):
    f = np.float32

    def reduce(r, u, w):
        return torch.stack([torch.dot(r, u), torch.dot(w, u),
                            torch.dot(r, r)]).numpy()

    x, r = torch.zeros_like(b), b.clone()
    bnorm = np.float32(torch.linalg.vector_norm(b).item())
    bnorm = np.float32(1.0) if bnorm == 0 else bnorm
    threshold = f(tol) * bnorm
    u = precond(r)
    w = spmv(a, u)
    p, s = torch.zeros_like(b), torch.zeros_like(b)
    gamma, delta, rn2 = reduce(r, u, w)
    history = [float(np.sqrt(rn2))]
    g_prev = a_prev = f(1.0)
    k = 0
    while np.sqrt(rn2) > threshold and k < maxiter:
        beta = f(0.0) if k == 0 else gamma / g_prev
        alpha = gamma / (delta - beta * gamma / a_prev)
        p = float(beta) * p + u
        s = float(beta) * s + w
        x = float(alpha) * p + x
        r = float(-alpha) * s + r
        u = precond(r)
        w = spmv(a, u)
        g_prev, a_prev = gamma, alpha
        gamma, delta, rn2 = reduce(r, u, w)
        k += 1
        history.append(float(np.sqrt(rn2)))
    return x, k, float(np.sqrt(rn2) / bnorm), history


def _host_dist_pcg(dh, b, tol, maxiter):
    a, d = dh.levels[0].a, dh.nshards
    x = [torch.zeros_like(t) for t in b]
    r = [t.clone() for t in b]
    bnorm = np.float32(pnorm(b).item())
    bnorm = np.float32(1.0) if bnorm == 0 else bnorm
    threshold = float(np.float32(tol) * bnorm)
    z = dist_vcycle(dh, r)
    p = z
    rz = pdot(r, z)
    rnorm = pnorm(r).item()
    history = [rnorm]
    k = 0
    while rnorm > threshold and k < maxiter:
        q = dist_spmv(a, p, d)
        alpha = rz / pdot(p, q)
        x = [xi + alpha * pi for xi, pi in zip(x, p)]
        r = [ri - alpha * qi for ri, qi in zip(r, q)]
        z = dist_vcycle(dh, r)
        rz_new = pdot(r, z)
        beta = rz_new / rz
        p = [zi + beta * pi for zi, pi in zip(z, p)]
        rz = rz_new
        k += 1
        rnorm = pnorm(r).item()
        history.append(rnorm)
    return x, k, float(rnorm / bnorm), history


def _host_dist_pcg_pipelined(dh, b, tol, maxiter):
    f = np.float32
    a, d = dh.levels[0].a, dh.nshards
    x = [torch.zeros_like(t) for t in b]
    r = b
    rn2 = f(pdot(b, b).item())
    bnorm2 = f(1.0) if rn2 == 0 else rn2
    threshold = f(tol) * f(tol) * bnorm2
    u = dist_vcycle(dh, r)
    w = dist_spmv(a, u, d)
    p = [torch.zeros_like(t) for t in b]
    s = [torch.zeros_like(t) for t in b]
    history = [float(np.sqrt(rn2))]
    g_prev = a_prev = f(1.0)
    k = 0
    while rn2 > threshold and k < maxiter:
        gamma, delta, rn2 = _pdots([(r, u), (w, u), (r, r)]).numpy()
        if k:
            history.append(float(np.sqrt(rn2)))
        beta = f(0.0) if k == 0 else gamma / g_prev
        alpha = gamma / (delta - beta * gamma / a_prev)
        p = [ui + float(beta) * pi for ui, pi in zip(u, p)]
        s = [wi + float(beta) * si for wi, si in zip(w, s)]
        x = [xi + float(alpha) * pi for xi, pi in zip(x, p)]
        r = [ri - float(alpha) * si for ri, si in zip(r, s)]
        u = dist_vcycle(dh, r)
        w = dist_spmv(a, u, d)
        g_prev, a_prev = gamma, alpha
        k += 1
    rnorm = pnorm(r).item()
    if k:
        history.append(rnorm)
    return x, k, float(rnorm / np.sqrt(bnorm2)), history


def _where_form_program(apply_a, precond, maxiter, dot=torch.dot,
                        norm=torch.linalg.vector_norm, vmap=G.vmap):
    """The standard PCG steps of earlier versions: every vector update a new
    tensor (a multiply by the 0-dim scalar and an add), per shard on shard
    lists, selected by ``torch.where(active, new, old)``, and z kept in the
    state."""
    def start(b, tol, x0):
        if x0 is None:
            x, r = vmap(torch.zeros_like, b), vmap(torch.clone, b)
        else:
            x, r = x0, b - apply_a(x0)
        bnorm = G.guard(norm(b))
        z = precond(r)
        rnorm = norm(r)
        hist, k = G.new_history(maxiter, rnorm)
        thr = tol * bnorm
        return dict(x=x, r=r, z=z, p=z, rz=dot(r, z), k=k,
                    active=(rnorm > thr) & (k < maxiter), hist=hist,
                    thr=thr, bnorm=bnorm)

    def step(st, masked):
        sel = G.selector(st["active"], masked)
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        q = apply_a(p)
        alpha = rz / dot(p, q)
        x_n = vmap(lambda xi, pi: xi + alpha * pi, x, p)
        r_n = vmap(lambda ri, qi: ri - alpha * qi, r, q)
        z_n = precond(r_n)
        rz_n = dot(r_n, z_n)
        beta = rz_n / rz
        p_n = vmap(lambda zi, pi: zi + beta * pi, z_n, p)
        rnorm = norm(r_n)
        k, active = G.advance(st, maxiter, rnorm > st["thr"])
        G.record(st["hist"], k, rnorm, st["active"])
        return dict(st, x=sel(x_n, x), r=sel(r_n, r), z=sel(z_n, st["z"]),
                    p=sel(p_n, p), rz=sel(rz_n, rz), k=k, active=active)

    def finish(st):
        k, history, bnorm = host_copy(st, "bnorm")
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(history[-1] / bnorm),
                        history=history)

    return G.Program(start, step, finish)


def _where_form_pipelined(a, precond, maxiter):
    """The single-device pipelined PCG steps of earlier versions: p, s, x
    and r made anew (``β·p + u``, ``β·s + w``, ``α·p + x``, ``(−α)·s + r``)
    and selected by ``torch.where(active, new, old)``."""
    def reduce(r, u, w):
        return torch.stack([torch.dot(r, u), torch.dot(w, u),
                            torch.dot(r, r)]).unbind()

    def start(b, tol, x0):
        if x0 is None:
            x, r = torch.zeros_like(b), b.clone()
        else:
            x, r = x0, b - spmv(a, x0)
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
        p = beta * st["p"] + st["u"]
        s = beta * st["s"] + st["w"]
        x = alpha * p + st["x"]
        r = -alpha * s + st["r"]
        u = precond(r)
        w = spmv(a, u)
        g_n, d_n, rn2 = reduce(r, u, w)
        rnorm = torch.sqrt(rn2)
        k, active = G.advance(st, maxiter, rnorm > st["thr"])
        G.record(st["hist"], k, rnorm, st["active"])
        return dict(st, x=sel(x, st["x"]), r=sel(r, st["r"]),
                    u=sel(u, st["u"]), w=sel(w, st["w"]), p=sel(p, st["p"]),
                    s=sel(s, st["s"]), gamma=sel(g_n, gamma),
                    delta=sel(d_n, delta), g_prev=sel(gamma, st["g_prev"]),
                    a_prev=sel(alpha, st["a_prev"]), k=k, active=active)

    def finish(st):
        k, history, bnorm = host_copy(st, "bnorm")
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(np.float32(history[-1]) / bnorm),
                        history=history)

    return G.Program(start, step, finish)


def _where_form_dist_pipelined(dh, maxiter):
    """The sharded pipelined PCG steps of earlier versions, from x = 0:
    p, s, x and r made anew per shard and selected by ``torch.where(active,
    new, old)``, r₀ the caller's b itself."""
    a, d, mesh = dh.levels[0].a, dh.nshards, dh.mesh

    def precond(r):
        return dist_vcycle(dh, r)

    def start(b, tol, x0):
        rn2 = pdot(b, b, mesh)
        bnorm2 = G.guard(rn2)
        u = precond(b)
        hist, k = G.new_history(maxiter, torch.sqrt(rn2))
        one = torch.ones_like(rn2)
        return dict(x=[torch.zeros_like(t) for t in b], r=b, u=u,
                    w=dist_spmv(a, u, d),
                    p=[torch.zeros_like(t) for t in b],
                    s=[torch.zeros_like(t) for t in b],
                    g_prev=one, a_prev=one.clone(), k=k,
                    active=(rn2 > tol * tol * bnorm2) & (k < maxiter),
                    hist=hist, thr=tol * tol * bnorm2, bnorm2=bnorm2)

    def step(st, masked):
        sel = G.selector(st["active"], masked)
        k0 = st["k"]
        gamma, delta, rn2 = _pdots([(st["r"], st["u"]), (st["w"], st["u"]),
                                    (st["r"], st["r"])], mesh).unbind()
        G.record(st["hist"], k0, torch.sqrt(rn2), st["active"] & (k0 > 0))
        beta = torch.where(k0 == 0, torch.zeros_like(gamma),
                           gamma / st["g_prev"])
        alpha = gamma / (delta - beta * gamma / st["a_prev"])
        p = [ui + beta * pi for ui, pi in zip(st["u"], st["p"])]
        s = [wi + beta * si for wi, si in zip(st["w"], st["s"])]
        x = [xi + alpha * pi for xi, pi in zip(st["x"], p)]
        r = [ri - alpha * si for ri, si in zip(st["r"], s)]
        u = precond(r)
        w = dist_spmv(a, u, d)
        k, active = G.advance(st, maxiter, rn2 > st["thr"])
        return dict(st, x=sel(x, st["x"]), r=sel(r, st["r"]),
                    u=sel(u, st["u"]), w=sel(w, st["w"]), p=sel(p, st["p"]),
                    s=sel(s, st["s"]), g_prev=sel(gamma, st["g_prev"]),
                    a_prev=sel(alpha, st["a_prev"]), k=k, active=active)

    def finish(st):
        rnorm = pnorm(st["r"], mesh)
        k, history, rnorm, bnorm2 = host_copy(dict(st, rnorm=rnorm),
                                              "rnorm", "bnorm2")
        history = history[:k] + [float(rnorm)] if k else history[:1]
        return CGResult(x=st["x"], iters=k,
                        rel_residual=float(float(rnorm) / np.sqrt(bnorm2)),
                        history=history)

    return G.Program(start, step, finish)


class _Owner:
    """Holds the where-form runners' cache (``G.run``'s owner)."""


def _same_as_host(res, host):
    x, k, rel, history = host
    assert res.iters == k
    assert res.history == history
    assert res.rel_residual == rel
    xs = res.x if isinstance(res.x, list) else [res.x]
    want = x if isinstance(x, list) else [x]
    assert all(torch.equal(u, v) for u, v in zip(xs, want))


# --- one device ------------------------------------------------------------

@pytest.mark.parametrize("k_block", [1, 3, 8])
@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg"])
def test_serial_blocks_bitwise_per_iteration_loop(serial, monkeypatch,
                                                  variant, k_block):
    hier, b = serial
    want = _serial_solve(variant, hier, b, graph=False)
    monkeypatch.setattr(G, "BLOCK", k_block)
    got = _serial_solve(variant, hier, b)
    assert got.iters > 3
    _same(want, got)


@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg"])
def test_serial_loop_bitwise_host_scalar_loop(serial, variant):
    """α and β as f32 device scalars give the host float32 loop's bits."""
    hier, b = serial
    a = hier.levels[0].a
    precond = ((lambda r: r) if variant == "cg"
               else (lambda r: port.vcycle(hier, r)))
    oracle = _host_pcg_pipelined if variant == "pipelined" else _host_pcg
    _same_as_host(_serial_solve(variant, hier, b, graph=False),
                  oracle(a, b, precond, TOL, 500))


def _x0(b):
    return torch.from_numpy(
        np.random.default_rng(3).standard_normal(b.numel())).to(b.dtype)


@pytest.mark.parametrize("start", ["zero", "x0"])
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg"])
def test_serial_bitwise_where_form_step(serial, monkeypatch, variant, graph,
                                        start):
    """The in-place updates give the where-form step's count, history and x
    bit for bit, on blocks of 3 (frozen iterations at the end) and on the
    per-iteration loop."""
    hier, b = serial
    a = hier.levels[0].a
    precond = ((lambda r: r) if variant == "cg"
               else (lambda r: port.vcycle(hier, r)))
    x0 = None if start == "zero" else _x0(b)
    monkeypatch.setattr(G, "BLOCK", 3)
    program = (_where_form_pipelined(a, precond, 500)
               if variant == "pipelined" else
               _where_form_program(lambda v: spmv(a, v), precond, 500))
    want = G.run(program, b, TOL, x0, graph=graph, owner=_Owner(),
                 key=variant)
    got = _serial_solve(variant, hier, b, graph=graph, x0=x0)
    assert got.iters > 3
    _same(want, got)


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg"])
def test_x0_left_unchanged(serial, variant, graph):
    hier, b = serial
    x0 = _x0(b)
    kept = x0.clone()
    res = _serial_solve(variant, hier, b, graph=graph, x0=x0)
    assert res.iters > 0
    assert torch.equal(x0, kept)
    assert res.x.data_ptr() != x0.data_ptr()


# --- shards ----------------------------------------------------------------

@pytest.mark.parametrize("k_block", [1, 3, 8])
@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
def test_sharded_blocks_bitwise_per_iteration_loop(monkeypatch, variant,
                                                   ndev, k_block):
    mesh, dh, bs = _mesh(ndev)
    want = make_dist_solver(mesh, dh, tol=TOL, variant=variant,
                            graph=False)(dh, bs)
    monkeypatch.setattr(G, "BLOCK", k_block)
    got = make_dist_solver(mesh, dh, tol=TOL, variant=variant)(dh, bs)
    assert got.iters > 3
    _same(want, got)


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
def test_sharded_loop_bitwise_host_scalar_loop(variant, ndev):
    mesh, dh, bs = _mesh(ndev)
    oracle = (_host_dist_pcg_pipelined if variant == "pipelined"
              else _host_dist_pcg)
    _same_as_host(make_dist_solver(mesh, dh, tol=TOL, variant=variant,
                                   graph=False)(dh, bs),
                  oracle(dh, bs, TOL, 200))


@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("ndev", [2, 4])
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
def test_sharded_bitwise_where_form_step(monkeypatch, variant, ndev, graph):
    """On shard lists the in-place updates give the where-form step's count,
    history and x bit for bit, on blocks of 3 and on the per-iteration
    loop."""
    mesh, dh, bs = _mesh(ndev)
    monkeypatch.setattr(G, "BLOCK", 3)
    if variant == "pipelined":
        program = _where_form_dist_pipelined(dh, 200)
    else:
        program = _where_form_program(
            lambda v: dist_spmv(dh.levels[0].a, v, dh.nshards),
            lambda r: dist_vcycle(dh, r), 200,
            dot=lambda u, v: pdot(u, v, dh.mesh),
            norm=lambda u: pnorm(u, dh.mesh), vmap=G.vmap)
    want = G.run(program, bs, TOL, graph=graph, owner=_Owner(), key=variant)
    got = make_dist_solver(mesh, dh, tol=TOL, variant=variant,
                           graph=graph)(dh, bs)
    assert got.iters > 3
    _same(want, got)


@pytest.mark.parametrize("given", ["full", "shards"])
@pytest.mark.parametrize("graph", [False, True])
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
def test_sharded_b_left_unchanged(variant, graph, given):
    mesh, dh, bs = _mesh(2)
    b = torch.cat(bs) if given == "full" else [t.clone() for t in bs]
    kept = torch.cat(bs).clone()
    res = make_dist_solver(mesh, dh, tol=TOL, variant=variant,
                           graph=graph)(dh, b)
    assert res.iters > 0
    assert torch.equal(torch.cat(b) if given == "shards" else b, kept)


# --- the reference's counts --------------------------------------------------

def _hierarchy_to_numpy(hier):
    levels = []
    for lv in hier.levels:
        d = {"dinv": np.asarray(lv.dinv), "lmax": float(np.asarray(lv.lmax))}
        if isinstance(lv.a, ref.Dia):
            d.update(a_data=np.asarray(lv.a.data), a_offsets=lv.a.offsets)
        else:
            d.update(a_col=np.asarray(lv.a.col), a_val=np.asarray(lv.a.val),
                     a_n_cols=lv.a.n_cols)
        for name in ("p", "r"):
            op = getattr(lv, name)
            d.update({f"{name}_col": np.asarray(op.col),
                      f"{name}_val": np.asarray(op.val),
                      f"{name}_n_cols": op.n_cols})
        levels.append(d)
    return levels, np.asarray(hier.coarse_chol)


@pytest.fixture(scope="module")
def carried():
    hier_j = ref_setup(ref.poisson3d_7pt(16, backend="numpy"),
                       RefParams(coarsening="pmis"))
    levels, chol = _hierarchy_to_numpy(hier_j)
    hier_t = port.hierarchy_from_numpy(levels, chol, hier_j.params,
                                       device="cpu")
    b = np.random.default_rng(5).standard_normal(16 ** 3).astype(np.float32)
    return hier_j, hier_t, b


@pytest.mark.parametrize("tol", [1e-6, 1e-7])
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
def test_inner_counts_equal_reference(carried, variant, tol):
    hier_j, hier_t, b = carried
    want = ref_amg_pcg(hier_j.levels[0].a, jnp.asarray(b), hier_j, tol=tol,
                       maxiter=200, variant=variant)
    got = port.amg_pcg(hier_t.levels[0].a, torch.from_numpy(b), hier_t,
                       tol=tol, maxiter=200, variant=variant)
    assert got.iters == int(want.iters)
    assert got.iters > 3
    np.testing.assert_allclose(got.rel_residual, float(want.rel_residual),
                               rtol=0.05)


# --- the edges ---------------------------------------------------------------

@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg",
                                     "sharded-standard", "sharded-pipelined"])
def test_maxiter_inside_a_block(serial, monkeypatch, variant):
    """maxiter = 5 with blocks of 3: the second block stops at 5."""
    hier, b = serial

    def solve(**kw):
        if variant.startswith("sharded"):
            mesh, dh, bs = _mesh(2)
            return make_dist_solver(mesh, dh, tol=1e-12, maxiter=5,
                                    variant=variant.split("-")[1],
                                    **kw)(dh, bs)
        return _serial_solve(variant, hier, b, maxiter=5, **kw) \
            if variant == "cg" else port.amg_pcg(
                hier.levels[0].a, b, hier, tol=1e-12, maxiter=5,
                variant=variant, **kw)

    want = solve(graph=False)
    monkeypatch.setattr(G, "BLOCK", 3)
    got = solve()
    assert got.iters == want.iters == 5
    assert len(got.history) == 6
    _same(want, got)


@pytest.mark.parametrize("variant", ["standard", "pipelined", "cg",
                                     "sharded-standard", "sharded-pipelined"])
@pytest.mark.parametrize("graph", [False, True])
def test_zero_rhs_takes_no_iteration(serial, variant, graph):
    hier, b = serial
    if variant.startswith("sharded"):
        mesh, dh, bs = _mesh(2)
        res = make_dist_solver(mesh, dh, tol=TOL,
                               variant=variant.split("-")[1], graph=graph)(
            dh, [torch.zeros_like(t) for t in bs])
        xs = res.x
    else:
        res = _serial_solve(variant, hier, torch.zeros_like(b), graph=graph)
        xs = [res.x]
    assert res.iters == 0
    assert res.history == [0.0]
    assert res.rel_residual == 0.0
    assert all(torch.count_nonzero(x) == 0 for x in xs)


class _Graphs:
    """Stands in for a captured runner (a CUDA graph needs the card)."""


@pytest.mark.parametrize("mesh", [False, True])
def test_refresh_drops_the_graphs(mesh):
    a = port.poisson3d_7pt(N_SHARDED if mesh else 8)
    kw = (dict(mesh=port.ShardMesh(2, "cpu"), agg_rows_per_dev=AGG)
          if mesh else {})
    solver = port.AMGSolver(a, PMIS, device="cpu", refreshable=True, **kw)
    old = solver.hierarchy
    runner = _Graphs()
    old.__dict__.setdefault("_graphs", {})[("standard", 1)] = runner
    alive = weakref.ref(runner)
    del runner
    assert alive() is not None
    solver.refresh(port.Dia(data=np.asarray(a.data) * 2.0,
                            offsets=a.offsets, dims=a.dims))
    gc.collect()
    assert solver.hierarchy is not old
    assert "_graphs" not in old.__dict__
    assert alive() is None
    assert "_graphs" not in solver.hierarchy.__dict__
