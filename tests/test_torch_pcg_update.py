"""The PCG's in-place vector updates through ``ops/pcg_update.py``:
the wrappers run the plain twin on CPU tensors without a launch, bit for bit
the where-form step they replace (kept here as it was: new vectors selected
by ``torch.where(active, new, old)``), for f32 and f64, with the flag true,
false and absent; a false flag leaves x, r and p as they were; the checks
raise.

On the card (marked ``cuda``, skipped elsewhere): the kernel against the
twin with ``torch.equal`` at lengths that exercise the 16-byte loads and
the scalar tail, and at a view 4 bytes off a 16-byte boundary (the scalar
path); the checks on CUDA tensors; and a captured solve of standard and
pipelined PCG, on one device and on a ``ShardMesh(2)`` of the card, with 2
launches (pipelined: 3) per shard and executed iteration, bit for bit the
where-form's per-iteration loop.
Run there with

    python -m pytest --noconftest tests/test_torch_pcg_update.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import omp_amg_tpu_torch as amg
from omp_amg_tpu_torch.ops import pcg_update

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
FLAGS = {"active": True, "frozen": False, "unmasked": None}


def _inputs(n, dtype, device="cpu", seed=0, flag=None):
    """(x, r, p, q, z, alpha, beta, active) with seeded normals; α and β
    formed as the step forms them (0-dim quotients of dots)."""
    rng = np.random.default_rng(seed)

    def vec():
        return torch.from_numpy(rng.standard_normal(n)).to(device, dtype)
    x, r, p, q, z = (vec() for _ in range(5))
    alpha = torch.dot(r, z) / torch.dot(p, q)
    beta = torch.dot(r, r) / torch.dot(z, z)
    active = None if flag is None else torch.tensor(flag, device=device)
    return x, r, p, q, z, alpha, beta, active


def _where_form(x, r, p, q, z, alpha, beta, active):
    """The step's vector updates before the kernel (new x, r, p): a multiply
    by the 0-dim scalar and an add per update, each selected by the flag."""
    def sel(new, old):
        return new if active is None else torch.where(active, new, old)
    return (sel(x + alpha * p, x), sel(r - alpha * q, r),
            sel(z + beta * p, p))


def _apply(x, r, p, q, z, alpha, beta, active):
    pcg_update.xr(x, r, p, q, alpha, active)
    pcg_update.p_update(p, z, beta, active)


# --- the wrappers on CPU tensors ---------------------------------------------

@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 5, 4097])
def test_cpu_twin_bitwise_where_form(n, dtype, flag):
    args = _inputs(n, DTYPES[dtype], seed=n, flag=FLAGS[flag])
    want = _where_form(*args)
    x, r, p = args[:3]
    ptrs = [v.data_ptr() for v in (x, r, p)]
    before = pcg_update.launches
    _apply(*args)
    assert pcg_update.launches == before
    assert [v.data_ptr() for v in (x, r, p)] == ptrs      # in place
    for got, w in zip((x, r, p), want):
        assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_frozen_slot_writes_nothing(dtype):
    args = _inputs(4097, DTYPES[dtype], seed=3, flag=False)
    kept = [v.clone() for v in args[:3]]
    _apply(*args)
    assert all(torch.equal(v, k) for v, k in zip(args[:3], kept))
    # and a NaN scalar changes nothing either
    nan = torch.tensor(float("nan"), dtype=DTYPES[dtype])
    pcg_update.xr(*args[:4], nan, args[-1])
    pcg_update.p_update(args[2], args[4], nan, args[-1])
    assert all(torch.equal(v, k) for v, k in zip(args[:3], kept))


def _bad(case, device="cpu"):
    """(callable, exception) that the wrappers must raise."""
    x, r, p, q, z, alpha, beta, active = _inputs(64, torch.float32, device,
                                                 flag=True)
    cases = {
        "int-dtype": lambda: pcg_update.xr(x.int(), r.int(), p.int(),
                                           q.int(), alpha.int()),
        "bf16-dtype": lambda: pcg_update.p_update(p.bfloat16(), z.bfloat16(),
                                                  beta.bfloat16()),
        "mixed-dtype": lambda: pcg_update.xr(x, r, p.double(), q, alpha),
        "scalar-dtype": lambda: pcg_update.p_update(p, z, beta.double()),
        "scalar-shape": lambda: pcg_update.xr(x, r, p, q, alpha.view(1)),
        "short": lambda: pcg_update.xr(x, r, p[:-1], q, alpha),
        "z-short": lambda: pcg_update.p_update(p, z[:-1], beta),
        "2-d": lambda: pcg_update.p_update(p.view(8, 8), z.view(8, 8), beta),
        "flag-dtype": lambda: pcg_update.xr(x, r, p, q, alpha,
                                            active.float()),
        "flag-shape": lambda: pcg_update.p_update(p, z, beta,
                                                  active.view(1)),
        "strided": lambda: pcg_update.xr(
            torch.zeros(128, device=device)[::2], r, p, q, alpha),
        "aliased": lambda: pcg_update.xr(x, r, x, q, alpha),
        "p-aliased": lambda: pcg_update.p_update(p, p, beta),
    }
    return cases[case], ValueError


BAD = ["int-dtype", "bf16-dtype", "mixed-dtype", "scalar-dtype",
       "scalar-shape", "short", "z-short", "2-d", "flag-dtype", "flag-shape",
       "strided", "aliased", "p-aliased"]


@pytest.mark.parametrize("case", BAD)
def test_checks_raise(case):
    fn, exc = _bad(case)
    before = pcg_update.launches
    with pytest.raises(exc):
        fn()
    assert pcg_update.launches == before


# --- on the card -------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CPU runs the plain twin)")


@pytest.mark.cuda
@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 3, 4, 4097, 16 ** 3 + 1, 256 ** 3])
def test_kernel_equals_twin(n, dtype, flag):
    _need_cuda()
    args = _inputs(n, DTYPES[dtype], "cuda", seed=n, flag=FLAGS[flag])
    want = _where_form(*args)
    before = pcg_update.launches
    _apply(*args)
    assert pcg_update.launches == before + 2
    torch.cuda.synchronize()
    for got, w in zip(args[:3], want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_unaligned_view(dtype):
    """Every operand a view one element (4 or 8 bytes) off a 16-byte
    boundary: the scalar path, the same bits."""
    _need_cuda()
    full = _inputs(4097 + 1, DTYPES[dtype], "cuda", seed=11, flag=True)
    args = [v[1:] for v in full[:5]] + list(full[5:])
    assert all(v.data_ptr() % 16 for v in args[:5])
    want = _where_form(*args)
    _apply(*args)
    torch.cuda.synchronize()
    for got, w in zip(args[:3], want):
        assert torch.equal(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAD)
def test_kernel_checks_raise(case):
    _need_cuda()
    fn, exc = _bad(case, "cuda")
    before = pcg_update.launches
    with pytest.raises(exc):
        fn()
    assert pcg_update.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["standard", "pipelined"])
@pytest.mark.parametrize("path", ["pmis", "structured", "z-slab",
                                  "pmis-mesh"])
def test_captured_solve_equals_where_form(path, variant, monkeypatch):
    """A captured PCG solve at 32³ through the kernel against the
    per-iteration loop with the twin (the where-form) in its place: count,
    history and x bit for bit; on a replay, 2 launches (pipelined: 3) per
    shard and executed iteration, frozen ones included. The mesh paths run
    on a ``ShardMesh(2)`` of the card."""
    _need_cuda()
    from omp_amg_tpu_torch.parallel.dist import make_dist_solver
    from omp_amg_tpu_torch.solvers import graph as G

    n = 32
    a = amg.poisson3d_7pt(n)
    grid = None if path.startswith("pmis") else (n,) * 3
    params = amg.AMGParams(coarsening="pmis") if grid is None else \
        amg.AMGParams()
    b = amg.default_rhs(a, seed=0).cuda()
    if path in ("z-slab", "pmis-mesh"):
        solver = amg.AMGSolver(a, params, grid=grid, device="cuda",
                               mesh=amg.ShardMesh(2, "cuda"),
                               transport="remote")
        hier, b, shards = solver.hierarchy, solver.mesh.shard(b), 2

        def solve(graph=True):
            return make_dist_solver(solver.mesh, hier, tol=1e-6,
                                    variant=variant, graph=graph)(hier, b)
    else:
        hier = amg.amg_setup(a, params, device="cuda", grid=grid)
        a0, shards = hier.levels[0].a, 1

        def solve(graph=True):
            return amg.amg_pcg(a0, b, hier, tol=1e-6, variant=variant,
                               graph=graph)

    def blocks():
        return sum(st["blocks"] for st in G.graph_stats(hier).values())
    solve()                                         # captures
    before, blocks0 = pcg_update.launches, blocks()
    got = solve()
    torch.cuda.synchronize()
    per_slot = 3 if variant == "pipelined" else 2
    assert pcg_update.launches - before == \
        per_slot * shards * G.BLOCK * (blocks() - blocks0)

    def twin(kind, n, scalar, active, u, v, s, t):
        if kind == 0:
            pcg_update.xr_twin(u, v, s, t, scalar, active)
        else:
            pcg_update.p_twin(u, s, scalar, active)
    monkeypatch.setattr(pcg_update, "_launch", twin)
    want = solve(graph=False)
    torch.cuda.synchronize()
    assert got.iters == want.iters > 3
    assert got.history == want.history
    xs, ws = (got.x, want.x) if shards > 1 else ([got.x], [want.x])
    assert len(xs) == shards
    assert all(torch.equal(u, v) for u, v in zip(xs, ws))
