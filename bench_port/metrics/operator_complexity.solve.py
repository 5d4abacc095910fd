"""operator_complexity.solve: the stored nonzeros of every level's operator
over the fine level's, Σ nnz_l / nnz_0, from the live solver's hierarchy
(``Hierarchy.level_nnz``, recorded by the PMIS setups; the fine level's
true nonzeros, not its DIA padding). None where the hierarchy records no
sizes."""


def read(run):
    if run.solver is None:
        return None
    nnz = getattr(run.solver.hierarchy, "level_nnz", ())
    if not nnz:
        return None
    return sum(nnz) / nnz[0]
