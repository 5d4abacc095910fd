"""The port's weak-scaling model (``parallel/scaling_model.py``) on the
port's hierarchies, on the CPU: the four cases of
``tests/test_scaling_model.py`` (structure and monotonicity, the two-host
gate of the slab family at 64³, the operator forms, the PMIS family and its
band), the slab family's per-level counts equal to the reference report's
on ``poisson3d_7pt(16)`` (the hierarchies are the same: ``ConstDia`` then
``Dia``), and a row-sharded ``DistHierarchy`` whose halo comes from its
``DistOp``. The efficiencies are not compared with the reference's: the
bytes per nonzero and the machine constants are the port's own.
"""

import dataclasses

import numpy as np
import pytest
import torch

import omp_amg_tpu as ref
from omp_amg_tpu.amg.hierarchy import amg_setup as ref_amg_setup
from omp_amg_tpu.parallel.scaling_model import (
    scaling_report as ref_scaling_report,
)

import omp_amg_tpu_torch as port
from omp_amg_tpu_torch.parallel.dist_pmis_setup import dist_pmis_setup
from omp_amg_tpu_torch.parallel.scaling_model import (
    MachineModel, _nnz_of, _op_bytes_per_nnz, scaling_report,
)
from omp_amg_tpu_torch.sparse.formats import ConstDia, dia_to_csr, to_const_dia

torch.set_num_threads(2)


def _structured(n):
    return port.amg_setup(port.poisson3d_7pt(n), grid=(n, n, n),
                          device="cpu")


def test_scaling_report_structure_and_monotonicity():
    n = 32
    hier = _structured(n)
    rep = scaling_report(hier, grid=(n, n, n), agg_rows_per_dev=2048,
                         measured_t_cycle_ms=3.0)
    assert rep["family"] == "slab"
    assert rep["model"]["hbm_gbps"] > 0
    assert len(rep["levels"]) == len(hier.levels)
    for lv in rep["levels"]:
        assert lv["bytes_per_cycle"] > 0
        assert lv["halo_bytes_per_exchange"] > 0
    eff = [rep["predicted"][nd]["weak_efficiency"]
           for nd in sorted(rep["predicted"])]
    assert eff[0] == 1.0
    assert all(a >= b - 1e-9 for a, b in zip(eff, eff[1:]))
    assert eff[-1] > 0.3
    assert abs(rep["predicted"][1]["t_cycle_ms"] - 3.0) < 1e-6
    assert rep["calibrated_to_measured"] is True


def test_scaling_report_two_host_gate():
    """The north-star gate (≥ 80 % at 2 hosts) under the port's
    constants, on the slab family at 64³."""
    n = 64
    rep = scaling_report(_structured(n), grid=(n, n, n))
    assert rep["predicted"][2]["weak_efficiency"] >= 0.8


def test_scaling_report_port_operator_forms():
    """Every storage form the port's levels hold is accounted: a
    ``ConstDia`` streams no values and counts its band, a ``Dia`` its
    planes, a ``Csr`` (f32 and bf16) its nonzeros with the index and indptr
    bytes; a hierarchy whose level 0 is swapped for each form reports."""
    n = 16
    a = port.poisson3d_7pt(n)
    hier = _structured(n)
    lv0 = hier.levels[0]
    cd = lv0.a if isinstance(lv0.a, ConstDia) else to_const_dia(lv0.a)
    band = sum(a.n_rows - abs(o) for o in a.offsets)
    assert _nnz_of(cd) == band and _op_bytes_per_nnz(cd) == 0.0
    dia = port.Dia(data=torch.from_numpy(np.asarray(a.data, np.float32)),
                   offsets=a.offsets, dims=a.dims)
    assert _nnz_of(dia) == len(a.offsets) * a.n_rows
    assert _op_bytes_per_nnz(dia) == 4.0
    csr = dia_to_csr(dia)
    nnz = port.dia_to_scipy(a).nnz        # the band less its masked zeros
    for c, vb in ((csr, 4), (dataclasses.replace(
            csr, vals=csr.vals.to(torch.bfloat16)), 2)):
        assert _nnz_of(c) == nnz == c.nnz
        assert _op_bytes_per_nnz(c) == pytest.approx(
            vb + 4 + 8 * (a.n_rows + 1) / nnz)
    for op in (cd, dia, csr):
        h2 = dataclasses.replace(hier, levels=(dataclasses.replace(
            lv0, a=op),) + tuple(hier.levels[1:]))
        rep = scaling_report(h2, grid=(n, n, n))
        assert rep["levels"][0]["nnz"] == _nnz_of(op)


def test_scaling_report_pmis_family_and_band():
    a = port.poisson3d_7pt(20)
    hier = port.amg_setup(a, port.AMGParams(coarsening="pmis"),
                          device="cpu")
    rep = scaling_report(hier, family="pmis", measured_t_cycle_ms=5.0)
    assert rep["family"] == "pmis"
    for ndev, p in rep["predicted"].items():
        assert p["weak_efficiency_lo"] <= p["weak_efficiency_hi"]
        if ndev > 1:
            assert p["weak_efficiency_lo"] <= p["weak_efficiency"] + 1e-9
            assert p["weak_efficiency"] <= p["weak_efficiency_hi"] + 1e-9
    assert scaling_report(hier)["family"] == "pmis"


def test_slab_levels_equal_reference_report():
    n = 16
    hier = _structured(n)
    hier_j = ref_amg_setup(ref.poisson3d_7pt(n), grid=(n, n, n))
    assert ([type(lv.a).__name__ for lv in hier.levels]
            == [type(lv.a).__name__ for lv in hier_j.levels]
            == ["ConstDia", "Dia"])
    rep = scaling_report(hier, grid=(n, n, n))
    rep_j = ref_scaling_report(hier_j, grid=(n, n, n))
    keys = ("n", "nnz", "nnz_p", "zdim", "halo_bytes_per_exchange",
            "exchanges_per_cycle", "op_format")
    assert ([{k: lv[k] for k in keys} for lv in rep["levels"]]
            == [{k: lv[k] for k in keys} for lv in rep_j["levels"]])
    assert rep["family"] == rep_j["family"] == "slab"
    assert set(rep["predicted"][2]) == set(rep_j["predicted"][2])
    assert "ici_gbps" not in rep["model"]
    assert rep["model"]["link_gbps"] == MachineModel().link_gbps


def test_dist_hierarchy_halo_from_its_operator():
    """A row-sharded hierarchy reports its ``DistOp`` levels' own strip
    widths and every shard's nonzeros."""
    a = port.poisson3d_7pt(16)
    mesh = port.ShardMesh(4, "cpu")
    dh = dist_pmis_setup(a, 4, port.AMGParams(coarsening="pmis"), mesh=mesh,
                         agg_rows_per_dev=64)
    rep = scaling_report(dh, family="pmis")
    lv0 = dh.levels[0].a
    assert lv0.mode == "halo"
    assert rep["levels"][0]["halo_bytes_per_exchange"] == 2 * lv0.halo * 4
    assert rep["levels"][0]["nnz"] == sum(b.nnz for b in lv0.blocks)
    assert rep["levels"][0]["n"] == lv0.n_rows
    assert rep["predicted"][1]["weak_efficiency"] == pytest.approx(1.0,
                                                                   abs=1e-3)
