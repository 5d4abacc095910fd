"""The reader of ``tiled_nnz_share.solve``: the share the live solver's
hierarchy reports (``Hierarchy.tiled_nnz_share``), 0 on a hierarchy with no
tiled operator, and silent where the program keeps no such record or no
solver runs."""

from types import SimpleNamespace

import numpy as np

from harness import spec

import omp_amg_tpu_torch as amg


def _run(hier):
    return SimpleNamespace(on_card=False,
                           solver=SimpleNamespace(hierarchy=hier))


def test_the_reader_reads_the_hierarchys_share():
    read = spec.reader("tiled_nnz_share.solve")
    assert read(_run(SimpleNamespace(tiled_nnz_share=0.46))) == 0.46
    # a PMIS hierarchy below the rule's size: no tiled operator
    hier = amg.amg_setup(amg.poisson3d_7pt(16),
                         amg.AMGParams(coarsening="pmis"), device="cpu")
    assert read(_run(hier)) == 0.0
    assert hier.tiled_nnz_share == 0.0 and np.isfinite(read(_run(hier)))


def test_the_reader_is_silent_without_the_record():
    read = spec.reader("tiled_nnz_share.solve")
    # the parent's hierarchy: no such property
    assert read(_run(SimpleNamespace(levels=(), level_nnz=()))) is None
    assert read(SimpleNamespace(on_card=False, solver=None)) is None
