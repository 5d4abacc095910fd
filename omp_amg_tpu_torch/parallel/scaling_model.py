"""Analytic weak-scaling model: per-level traffic accounting and predicted
multi-card efficiency (counterpart of
``omp_amg_tpu/parallel/scaling_model.py``).

The reference's model, formulas and report keys, fed by the port's own
operators: bytes per nonzero follow the port's storage types (``Csr``,
``Dia``, ``ConstDia``, and the per-shard blocks of ``SlabDia`` and
``DistOp``), and the machine constants are an H100's, measured on the card
by committed code where one card can measure them.

Model (stated in the emitted report):

- compute: every solve-path op is memory-bound; T_comp = bytes_moved /
  hbm_bw + 2 · stage_latency (two calls per level and cycle at least);
- halo exchange: each sharded-level product exchanges its boundary strips
  with the neighbours over the link between cards; T_level =
  max(T_interior, T_halo) + T_boundary (the reference's overlap split);
- collectives: scalar sums, latency-bound at log2(ndev) hops; PCG does 3
  per iteration;
- weak scaling: the problem grows with ndev (per-device level sizes
  constant), efficiency(ndev) = T_cycle(1) / T_cycle(ndev);
- levels below the agglomeration threshold replicate: their work is the
  Amdahl serial fraction.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import asdict, dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class MachineModel:
    """Machine assumptions: one NVIDIA H100 80GB HBM3 per device, its
    neighbours over NVLink.

    Measured by ``chip_smoke.py`` phase 16c on an NVIDIA H100 80GB HBM3
    with a 700.00 W power limit: ``hbm_gbps`` (a device-to-device copy of
    1 GiB, bytes read plus bytes written over its CUDA-event time),
    ``stage_latency_us`` (one ``csr_spmv`` launch on a 1024-row operator,
    CUDA events, each call after an L2 flush and a ~1 ms spin).

    Not measurable with one card, and stated as an assumption:
    ``link_gbps`` and ``link_latency_us``. NVIDIA's H100 SXM5 data sheet
    gives NVLink 4 at 900 GB/s bidirectional per GPU, 450 GB/s each way;
    the data sheet gives no latency, and 1 µs per hop is the reference's
    own assumption, carried over. The report's ``_lo``/``_hi`` band takes
    both ±2×.
    """

    hbm_gbps: float = 2996.7
    stage_latency_us: float = 6.482
    link_gbps: float = 450.0          # NVLink 4, per direction (data sheet)
    link_latency_us: float = 1.0      # assumed (the reference's)


def _value_bytes(t) -> int:
    return t.element_size() if isinstance(t, torch.Tensor) else int(
        np.asarray(t).dtype.itemsize)


def _op_bytes_per_nnz(op) -> float:
    """Streamed operator bytes per nonzero for the solve-path product:
    ``Csr`` its value bytes, the int32 column and its share of the int64
    ``indptr``; ``TileCsr`` the same with a 16-bit index plus its tiles'
    int32 column lists; ``Dia`` its planes' value bytes; ``ConstDia`` none (the
    kernel reads vectors only); ``SlabDia`` and ``DistOp`` their per-shard
    blocks'."""
    name = type(op).__name__
    if name == "ConstDia":
        return 0.0
    if name == "Csr":
        nnz = max(op.nnz, 1)
        return _value_bytes(op.vals) + 4 + 8 * (op.n_rows + 1) / nnz
    if name == "TileCsr":   # 16-bit index, and the tiles' column lists
        nnz = max(op.nnz, 1)
        return (_value_bytes(op.vals) + 2 + 4 * op.unique_share
                + 8 * (op.n_rows + 1) / nnz)
    if name == "Dia":
        return float(_value_bytes(op.data))
    if name == "SlabDia":
        return float(_value_bytes(op.data[0]))
    if name == "DistOp":
        return _op_bytes_per_nnz(op.blocks[0])
    return 8.0         # ELL planes: int32 column + f32 value


def _nnz_of(op) -> int:
    """Stored nonzeros (banded forms: their planes; a ``ConstDia``: the
    band's length; sharded forms: every shard's)."""
    name = type(op).__name__
    if name == "SlabDia":
        return len(op.offsets) * op.n_rows
    if name == "DistOp":
        local = sum(_nnz_of(b) for b in op.blocks)
        return local * op.nshards // len(op.blocks)
    if hasattr(op, "nnz"):
        n = op.nnz
        return int(n) if not callable(n) else int(n())
    if hasattr(op, "data"):
        return int(np.prod(tuple(op.data.shape)))
    if hasattr(op, "offsets"):
        n = int(op.shape[0])
        return sum(n - abs(int(o)) for o in op.offsets)
    return 0


def _n_rows(op) -> int:
    return int(op.n_rows) if hasattr(op, "n_rows") else int(op.shape[0])


def scaling_report(hier, grid=None, ndev_list=(1, 2, 4, 8, 16),
                   machine: MachineModel = MachineModel(),
                   agg_rows_per_dev: int = 2048,
                   measured_t_cycle_ms: float | None = None,
                   family: str = "auto") -> dict:
    """Per-level accounting and predicted weak-scaling efficiency.

    ``hier`` is a port ``Hierarchy`` (or a ``DistHierarchy``); the model
    shards it as the distributed setups do, ``family="slab"`` (z-plane
    slabs, plane halo exchanges) or ``family="pmis"`` (row blocks with
    strip halos), at each device count with the weak-scaled problem.
    ``family="auto"`` picks pmis when any level operator is a ``Csr``, a
    ``TileCsr`` or a ``DistOp``, or no grid is given.
    ``measured_t_cycle_ms`` (one card's V-cycle) calibrates the absolute
    scale; efficiencies are scale-free.
    The ``_lo``/``_hi`` band takes the link constants (an assumption, not a
    measurement) ±2×.
    """
    params = hier.params
    nu = params.nu_pre + params.nu_post
    spmv_per_cycle = nu + 1
    if family == "auto":
        general = any(type(lv.a).__name__ in ("Csr", "TileCsr", "DistOp")
                      for lv in hier.levels)
        family = "pmis" if (general or grid is None) else "slab"

    levels = []
    for lv in hier.levels:
        n = _n_rows(lv.a)
        nnz = _nnz_of(lv.a)
        nnz_p = _nnz_of(lv.p)
        opb = _op_bytes_per_nnz(lv.a)
        # bytes per cycle at this level (vectors: x + y per op, f32)
        level_bytes = (spmv_per_cycle * (nnz * opb + 2 * 4 * n)
                       + 2 * (nnz_p * _op_bytes_per_nnz(lv.p) + 4 * n)
                       + nu * 3 * 4 * n)
        zdim = None
        if family == "slab" and grid is not None and len(grid) == 3:
            frac = (n / (grid[0] * grid[1] * grid[2])) ** (1.0 / 3.0)
            nz = max(int(round(grid[0] * frac)), 1)
            plane_rows = n // max(nz, 1)
            zdim = nz
            halo_bytes = 2 * plane_rows * 4      # two boundary x planes
        else:
            # row-block shard: a DistOp knows its strip width; otherwise
            # the distance-1 reach of a 7-point-lineage operator, one grid
            # plane of n^(2/3) rows
            if type(lv.a).__name__ == "DistOp" and lv.a.mode == "halo":
                halo_rows = min(n, int(lv.a.halo))
            else:
                halo_rows = min(n, int(max(n, 1) ** (2.0 / 3.0)))
            halo_bytes = 2 * halo_rows * 4
        flops = 2 * nnz * spmv_per_cycle + 4 * nnz_p
        levels.append(dict(n=n, nnz=nnz, nnz_p=nnz_p, zdim=zdim,
                           op_format=type(lv.a).__name__,
                           bytes_per_cycle=level_bytes,
                           halo_bytes_per_exchange=halo_bytes,
                           exchanges_per_cycle=spmv_per_cycle + 2,
                           flops_per_cycle=flops))

    def _predict(m):
        return _predict_family(levels, hier, m, ndev_list, family,
                               agg_rows_per_dev)

    predictions = _predict(machine)
    pess = dataclasses.replace(machine, link_gbps=machine.link_gbps / 2,
                               link_latency_us=machine.link_latency_us * 2)
    opti = dataclasses.replace(machine, link_gbps=machine.link_gbps * 2,
                               link_latency_us=machine.link_latency_us / 2)
    pred_lo = _predict(pess)
    pred_hi = _predict(opti)

    t1 = predictions[ndev_list[0]]["t_cycle_ms"]
    calib = (measured_t_cycle_ms / t1) if measured_t_cycle_ms else 1.0
    for ndev, p in predictions.items():
        p["t_cycle_ms"] = round(p["t_cycle_ms"] * calib, 4)
        p["weak_efficiency"] = round(t1 * calib / p["t_cycle_ms"], 4)
        for tag, alt in (("weak_efficiency_lo", pred_lo),
                         ("weak_efficiency_hi", pred_hi)):
            p[tag] = round(alt[ndev_list[0]]["t_cycle_ms"]
                           / alt[ndev]["t_cycle_ms"], 4)

    lat = machine.link_latency_us * 1e-6
    pcg = {ndev: dict(
        psum_per_iter=3,
        t_collectives_us=round(3 * math.log2(max(ndev, 2)) * lat * 1e6, 3))
        for ndev in ndev_list}

    return dict(
        family=family,
        model=asdict(machine),
        model_notes=(
            "weak scaling: per-device level sizes constant (problem grows "
            "with ndev); T_level = max(T_interior, T_halo) + T_boundary on "
            "sharded levels; replicated levels are the Amdahl serial "
            "fraction; scalar sums latency-bound at log2(ndev) hops; bytes "
            "per nonzero are the port's storage types' (Csr value + int32 "
            "column + int64 indptr share, Dia planes, ConstDia none); "
            "hbm_gbps and stage_latency_us were measured on one H100 "
            "(chip_smoke.py phase 16c); the link "
            "constants are NVLink 4's data-sheet rate and the reference's "
            "assumed per-hop latency, and the _lo/_hi band takes them ±2× (an assumption, "
            "not a measurement)"),
        levels=levels,
        predicted=predictions,
        pcg_collectives=pcg,
        calibrated_to_measured=measured_t_cycle_ms is not None,
    )


def _predict_family(levels, hier, machine, ndev_list, family,
                    agg_rows_per_dev):
    hbm = machine.hbm_gbps * 1e9
    link = machine.link_gbps * 1e9
    lat = machine.link_latency_us * 1e-6
    stage = machine.stage_latency_us * 1e-6

    predictions = {}
    for ndev in ndev_list:
        t_cycle = 0.0
        t_halo_exposed = 0.0
        n_sharded = n_replicated = 0
        for lv in levels:
            sharded = ndev > 1 and lv["n"] >= agg_rows_per_dev
            if lv["zdim"] is not None:
                sharded = sharded and lv["zdim"] >= 2
            if ndev == 1:
                sharded = False
            t_comp = lv["bytes_per_cycle"] / hbm + 2 * stage
            if ndev == 1:
                t_cycle += t_comp
            elif sharded:
                n_sharded += ndev > 1
                boundary_frac = (min(2.0 / max(lv["zdim"] or 8, 2), 0.5)
                                 if lv["zdim"] else 0.1)
                t_halo = lv["exchanges_per_cycle"] * (
                    lv["halo_bytes_per_exchange"] / link + lat)
                t_int = t_comp * (1 - boundary_frac)
                t_bnd = t_comp * boundary_frac
                t_cycle += max(t_int, t_halo) + t_bnd
                t_halo_exposed += max(0.0, t_halo - t_int)
            else:
                n_replicated += 1
                t_cycle += lv["bytes_per_cycle"] * ndev / hbm + 2 * stage
        nc = int(hier.coarse_chol.shape[0])
        t_coarse = 2 * (nc * nc * 4) / hbm + 2 * stage
        t_cycle += t_coarse * (1 + math.log2(ndev) if ndev > 1 else 1)
        t_cycle += 3 * math.log2(max(ndev, 2)) * lat if ndev > 1 else 0.0
        predictions[ndev] = dict(t_cycle_ms=t_cycle * 1e3,
                                 halo_exposed_ms=round(t_halo_exposed * 1e3,
                                                       5),
                                 sharded_levels=n_sharded,
                                 replicated_levels=int(n_replicated))
    return predictions
