"""tiled_nnz_share.solve: the share of the stored nonzeros of every level's
A, P and R that sit in the tiled CSR form, from the live solver's hierarchy
(``Hierarchy.tiled_nnz_share``: a ``Csr``'s or ``TileCsr``'s nonzeros, a
``Dia``'s nonzero entries; matrix-free operators store none). 0 where no
operator took the form; None where the program keeps no such record."""


def read(run):
    if run.solver is None:
        return None
    return getattr(run.solver.hierarchy, "tiled_nnz_share", None)
