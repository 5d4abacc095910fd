"""The plain reference, and the operators handed to the program, against
scipy at a small size, for stencils stated as data: the configurations'
7-point one, a 27-point one and a 2D anisotropic 9-point one."""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import reference

SEVEN = ([[-1, 0, 0], [0, -1, 0], [0, 0, -1], [0, 0, 0], [0, 0, 1],
          [0, 1, 0], [1, 0, 0]], [-1, -1, -1, 6, -1, -1, -1])
TWENTY_SEVEN = ([list(t) for t in itertools.product((-1, 0, 1), repeat=3)],
                [26.0 if t == (0, 0, 0) else -1.0
                 for t in itertools.product((-1, 0, 1), repeat=3)])
# rotated anisotropy (eps 0.001, 45 degrees), as a 9-point 2D stencil
ANISO_2D = ([[-1, -1], [-1, 0], [-1, 1], [0, -1], [0, 0], [0, 1], [1, -1],
             [1, 0], [1, 1]],
            [0.24975, -0.5005, -0.24975, -0.5005, 2.002, -0.5005, -0.24975,
             -0.5005, 0.24975])
STENCILS = {"7pt": SEVEN, "27pt": TWENTY_SEVEN, "aniso9pt_2d": ANISO_2D}


def config(name: str, n: int) -> dict:
    taps, coeffs = STENCILS[name]
    return {"n": n, "stencil": {"name": name, "taps": taps,
                                "coefficients": coeffs}}


def scipy_operator(cfg: dict, shift: float) -> sp.csr_matrix:
    """A + shift·I as a sum of Kronecker products of shifted identities."""
    n = cfg["n"]
    st = cfg["stencil"]
    a = shift * sp.identity(n ** len(st["taps"][0]))
    for tap, c in zip(st["taps"], st["coefficients"]):
        term = sp.identity(1)
        for d in tap:
            term = sp.kron(term, sp.eye(n, k=d))
        a = a + c * term
    return a.tocsr()


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_residual_matches_scipy(name):
    cfg = config(name, 6)
    shift = 2.0 ** -3
    dim = len(cfg["stencil"]["taps"][0])
    rng = np.random.default_rng(0)
    b = rng.standard_normal(6 ** dim)
    x = rng.standard_normal(6 ** dim)
    a = scipy_operator(cfg, shift)
    want = np.linalg.norm(b - a @ x) / np.linalg.norm(b)
    got = reference.rel_residual(cfg, shift, torch.from_numpy(b),
                                 torch.from_numpy(x))
    assert abs(got - want) <= 1e-14 * want
    exact = sp.linalg.spsolve(a.tocsc(), b)
    assert reference.rel_residual(cfg, shift, torch.from_numpy(b),
                                  torch.from_numpy(exact)) < 1e-12


@pytest.mark.parametrize("name", sorted(STENCILS))
def test_the_planes_handed_to_the_program_are_the_reference_operator(name):
    from harness import problems

    cfg = config(name, 5)
    shift = 2.0 ** -7
    a = scipy_operator(cfg, shift).toarray()
    taps = problems.stencil(cfg)
    offs = problems.offsets(5, taps)
    assert list(offs) == sorted(offs)
    rows = a.shape[0]
    for planes in (problems.host_planes(5, taps),
                   problems.device_planes(5, taps, "cpu").double().numpy()):
        planes = planes.copy()
        planes[offs.index(0)] += shift
        dense = np.zeros((rows, rows))
        for k, off in enumerate(offs):
            for i in range(rows):
                if planes[k, i]:
                    dense[i, i + off] = planes[k, i]
        assert np.allclose(dense, a, rtol=0, atol=1e-6)


def test_a_stencil_without_its_centre_is_refused():
    from harness import problems

    cfg = config("7pt", 4)
    cfg["stencil"]["taps"] = cfg["stencil"]["taps"][:3]
    cfg["stencil"]["coefficients"] = cfg["stencil"]["coefficients"][:3]
    with pytest.raises(ValueError):
        problems.stencil(cfg)
