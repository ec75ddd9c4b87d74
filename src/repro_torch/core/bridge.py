"""Bridge: COSMIC design points <-> executable mesh plans, and calibration
of the analytical simulator against the dry run's counts.

This closes the loop the paper leaves open: a discovered (DP, SP, PP, TP,
weight-sharded) workload point becomes a concrete ``DeviceMesh`` +
``ShardingPlan`` the real train/serve step runs under, and the simulator's
compute/collective terms can be cross-checked against the per-device totals
of the dry run (``launch/dryrun.py``, a ``core.hlo_analysis.CostTotals``).

The port's own copy of the JAX package's ``core/bridge.py``: the same logic,
with ``MeshPlan.make_mesh`` over the port's ``launch/mesh.py``.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

from repro_torch.core.hlo_analysis import CostTotals
from repro_torch.core.workload import Parallelism, Trace


@dataclass(frozen=True)
class MeshPlan:
    """A realizable mesh layout for a discovered design point."""
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    fsdp: bool
    sp: bool

    def make_mesh(self, *, device=None):
        """The ``DeviceMesh`` of this layout over the default process group
        (whose world must be its size), on the card unless ``device`` says
        otherwise."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(self.shape, self.axis_names, device=device)


def plan_from_design(par: Parallelism) -> MeshPlan:
    """Map COSMIC workload knobs onto mesh axes.

    dp*sp -> 'data'-like axes (sp realized as sequence sharding over
    'model' in-layer, so the mesh folds sp into data), tp -> 'model',
    pp -> 'pipe' (outermost).
    """
    axes: list[tuple[str, int]] = []
    if par.pp > 1:
        axes.append(("pipe", par.pp))
    axes.append(("data", par.dp * par.sp))
    axes.append(("model", par.tp))
    shape = tuple(n for _, n in axes if n > 1) or (1,)
    names = tuple(a for a, n in axes if n > 1) or ("data",)
    return MeshPlan(shape, names, fsdp=par.weight_sharded, sp=par.sp > 1)


def design_from_mesh(axis_sizes: dict[str, int], *, weight_sharded: bool = True,
                     sp: bool = True) -> Parallelism:
    """Inverse: what design point does a production mesh realize?"""
    n = 1
    for v in axis_sizes.values():
        n *= v
    dp = axis_sizes.get("data", 1) * axis_sizes.get("pod", 1)
    pp = axis_sizes.get("pipe", 1)
    tp_sp = axis_sizes.get("model", 1)
    # sequence parallelism rides the model axis in our runtime
    return Parallelism(n_npus=n, dp=dp, sp=1, pp=pp, weight_sharded=weight_sharded)


# ---------------------------------------------------------------------------
# calibration: analytical trace vs. compiled HLO
# ---------------------------------------------------------------------------

@dataclass
class Calibration:
    """Per-term ratios (simulated / compiled).  A ratio near 1.0 means the
    analytical model tracks the compiler's schedule; large deviations flag
    modeling gaps (or compiler waste, e.g. remat recompute)."""
    flops_ratio: float
    coll_bytes_ratio: float
    detail: dict[str, Any]


def calibrate(trace: Trace, hlo: CostTotals, n_chips: int) -> Calibration:
    sim_flops = trace.total_flops()
    hlo_flops = hlo.flops
    sim_coll = sum(trace.total_coll_bytes().values())
    hlo_coll = hlo.total_collective_bytes()
    return Calibration(
        flops_ratio=sim_flops / hlo_flops if hlo_flops else float("nan"),
        coll_bytes_ratio=sim_coll / hlo_coll if hlo_coll else float("nan"),
        detail={
            "sim_flops": sim_flops, "hlo_flops_per_device": hlo_flops,
            "sim_coll_bytes": sim_coll, "hlo_coll_bytes_per_device": hlo_coll,
            "sim_coll_by_group": trace.total_coll_bytes(),
            "hlo_coll_by_kind": dict(hlo.collective_bytes),
        },
    )
