"""Colored-probing Galerkin RAP: the device numeric phase of the PMIS setup
with ``AMGParams(rap="probe")``.

Counterpart of ``omp_amg_tpu/ops/probe_rap.py``. The symbolic phase runs on
the host, once per level; the numeric phase runs on the device:

1. colour the columns of A_c = PᵀAP so that no two columns sharing a row get
   the same colour (distance-2 greedy: ``d2_color``, the port's native
   colouring first, its numpy twin otherwise; any number of colours);
2. for each group of at most 128 colours, build the (n, C) panel PV = P·V of
   the one-hot colour panel V (one deterministic scatter per P slot), then
   U = A·PV and W_g = Pᵀ·U with the panel SpMM kernel
   (``ops/panel_spmm.py``);
3. A_c[i, s] = W[i, colour(col(i, s))] with the gather kernel
   (``ops/extract_lanes.py``). No two columns of a row share a colour, so
   the extraction is exact.

Design against the reference:

- A runs as f32 CSR on every level. The reference runs a banded A as a
  shift-and-add over the panel; the CSR kernel sums the same products in the
  same ascending-column order, so there is no banded special case here.
- Group g's panel is C_g = its colour count rounded up to a multiple of 32
  wide. Every group but the last holds 128 colours, so colour c is column c
  of W = [W_0 | W_1 | …]: no colour-to-column map is needed.
- The reference's panel plans, roll schedules and engine cost model size
  and schedule TPU VMEM windows and are not ported. With them go their caps
  (``sparse/panels.py``, where ``plan_panel_spmm`` returns None): a level
  the reference leaves to the host because a plan cap is exceeded is probed
  here.
- The reference's colouring (``csrc/native.cc``'s ``d2_color_greedy``) keeps
  its colour masks 4 words wide and gives up above 256 colours; the
  reference then keeps that level's host values. The port colours with no
  cap (``csrc/d2_color.cc``: the same greedy, masks widened on demand), so
  every level is probed: a 27-point operator's wide coarse rows need more
  than 256 colours. Below 256 colours the two colourings are the same, bit
  for bit, and so are the hierarchies. The colour groups, the panel SpMM
  and the gather take any number of colours.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sparse.formats import Csr, csr_from_scipy, ell_planes_from_scipy
from .extract_lanes import extract_lanes
from .panel_spmm import spmm_panel

GROUP = 128          # colours per probe group
ALIGN = 32           # panel widths are multiples of one warp


def d2_color(ac):
    """Distance-2 greedy column colouring (native; numpy twin when the
    library is missing). Both walk the columns in ascending order with
    per-row colour bitmasks and take the lowest free colour, so they give
    the same colouring, and below 256 colours the reference's. Returns
    (colours, n_colours)."""
    from .. import native

    out = native.d2_color_wide(ac)
    return out if out is not None else _d2_color_np(ac)


def _d2_color_np(ac):
    """The numpy twin of ``d2_color``: masks as wide as the longest row
    needs, doubled whenever a column finds every colour taken."""
    import scipy.sparse as sp

    csc = sp.csc_matrix(ac)
    n_rows, n_cols = csc.shape
    longest = int(np.bincount(csc.indices, minlength=n_rows).max()) \
        if csc.nnz else 0
    words = max(1, -(-longest // 64))
    rowmask = np.zeros((n_rows, words), np.uint64)
    colors = np.empty(n_cols, np.int32)
    ncolors = 0
    indptr, indices = csc.indptr, csc.indices
    for j in range(n_cols):
        rows = indices[indptr[j]:indptr[j + 1]]
        forb = np.bitwise_or.reduce(rowmask[rows], axis=0) if len(rows) \
            else np.zeros(words, np.uint64)
        c = -1
        for w in range(words):
            free = int(~forb[w]) & ((1 << 64) - 1)
            if free:
                c = w * 64 + ((free & -free).bit_length() - 1)
                break
        if c < 0:
            # every colour below 64·words is taken: widen the masks
            c = 64 * words
            rowmask = np.hstack([rowmask, np.zeros_like(rowmask)])
            words *= 2
        colors[j] = c
        ncolors = max(ncolors, c + 1)
        rowmask[rows, c >> 6] |= np.uint64(1) << np.uint64(c & 63)
    return colors, ncolors


@dataclass(frozen=True)
class RapProbe:
    """Host-built symbolic phase on the device; ``rap_probe_numeric`` runs
    the numeric phase."""

    a: Csr                  # A, f32
    r: Csr                  # R = Pᵀ, f32
    p_val: torch.Tensor     # (n, kP) f32: P's values as ELL planes
    p_color: torch.Tensor   # (n, kP) int32: colour of P's column, -1 on
                            # padding
    ac_cidx: torch.Tensor   # (nc, kc) int32: colour of A_c's column per
                            # slot (= its column of W), 0 on padding
    ac_mask: torch.Tensor   # (nc, kc) f32: 1 on real slots, 0 on padding
    n_colors: int

    @property
    def groups(self) -> list:
        """(first colour, panel width) of every colour group."""
        return [(g0, -(-min(GROUP, self.n_colors - g0) // ALIGN) * ALIGN)
                for g0 in range(0, self.n_colors, GROUP)]


def ell_slots(m, width: int) -> np.ndarray:
    """(rows, width) bool: slot s of row i is real iff s < nnz(row i). For a
    zero-free CSR matrix the real ELL slots of a row, in order, are its CSR
    positions."""
    return np.arange(width)[None, :] < np.diff(m.indptr)[:, None]


def build_rap_probe(a_sp, p_sp, ac_sp=None, *, device):
    """Host symbolic phase, its planes uploaded to ``device`` (and there
    the kernel library loaded); ``ac_sp`` (the pattern of PᵀAP, zero-free
    and sorted) is computed with ``galerkin_product`` if not given.

    Returns (RapProbe on ``device``, ac_sp)."""
    import scipy.sparse as sp

    from .rap import galerkin_product

    a_sp = sp.csr_matrix(a_sp)
    p_sp = sp.csr_matrix(p_sp)
    if ac_sp is None:
        ac_sp = galerkin_product(a_sp, p_sp)
    colors, ncolors = d2_color(ac_sp)

    if np.count_nonzero(ac_sp.data) != ac_sp.nnz:
        raise ValueError("A_c pattern holds explicit zeros: its ELL slots "
                         "would not align with its CSR positions")
    # f32 planes (the native fill); A_c's real slots from its row lengths
    p_col, p_val, _ = ell_planes_from_scipy(p_sp, dtype=np.float32)
    p_color = np.where(p_val != 0, colors[p_col], -1).astype(np.int32)
    ac_col, _, _ = ell_planes_from_scipy(ac_sp, dtype=np.float32)
    real = ell_slots(ac_sp, ac_col.shape[1])

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    probe = RapProbe(
        a=csr_from_scipy(a_sp, torch.float32, device=device),
        r=csr_from_scipy(p_sp.T.tocsr(), torch.float32, device=device),
        p_val=dev(p_val),
        p_color=dev(p_color),
        ac_cidx=dev(np.where(real, colors[ac_col], 0).astype(np.int32)),
        ac_mask=dev(real.astype(np.float32)),
        n_colors=int(ncolors))
    if torch.device(device).type == "cuda":
        # the kernel library's first build and load land here, so that the
        # numeric phase holds its device work alone
        from .._build import cuda_kernels

        cuda_kernels()
    return probe, ac_sp


def panel_pv(probe: RapProbe, c0: int, width: int) -> torch.Tensor:
    """(n, width) f32 slice of P·V for colours [c0, c0 + width).

    PV[i, c] = Σ_k P.val[i, k]·(P.color[i, k] == c0 + c), summed in slot
    order as the reference's compare-accumulate (``_panel_pv``) sums it. One
    scatter per slot: each row contributes one index per slot, so no index
    repeats within a scatter and the result does not depend on the order of
    writes (no ``index_put_(accumulate=True)``)."""
    n, kp = probe.p_val.shape
    dev = probe.p_val.device
    pv = torch.zeros(n * width, dtype=torch.float32, device=dev)
    base = torch.arange(n, dtype=torch.int64, device=dev) * width
    for k in range(kp):
        c = probe.p_color[:, k].long() - c0
        hit = (c >= 0) & (c < width)
        flat = base + torch.where(hit, c, 0)
        add = torch.where(hit, probe.p_val[:, k], 0.0)
        pv[flat] = pv[flat] + add
    return pv.view(n, width)


def rap_probe_numeric(probe: RapProbe) -> torch.Tensor:
    """Device numeric phase: A_c's values as (nc, kc) f32 ELL planes (0 on
    padding), on the probe's device. At most two (n, C) panels are alive at
    a time."""
    parts = []
    for c0, width in probe.groups:
        pv = panel_pv(probe, c0, width)
        u = spmm_panel(probe.a, pv)
        del pv
        parts.append(spmm_panel(probe.r, u))
        del u
    w = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return extract_lanes(w, probe.ac_cidx) * probe.ac_mask
