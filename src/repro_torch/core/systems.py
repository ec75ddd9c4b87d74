"""System-preset registry: named target systems for the whole DSE stack.

A ``SystemPreset`` bundles what used to be hand-wired per benchmark script:
the cluster size, the compute device (paper Table 3), and the Table-3
baseline stack defaults used to pin non-searched stacks in single-stack
ablations.  ``StudySpec.system`` resolves here, as do the benchmark
helpers — adding a new target system is one ``register_system`` call, not a
new copy of the assembly code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from repro_torch.core.compute import (SYSTEM_1_DEVICE, SYSTEM_2_DEVICE,
                                SYSTEM_3_DEVICE, Device)
from repro_torch.core.psa import ParameterSet, paper_psa


@dataclass(frozen=True)
class SystemPreset:
    """One named target system: cluster size + device + baseline stacks.

    ``base_defaults`` are the Table-3 baseline values for the collective and
    network stacks; ``workload_defaults`` the baseline parallelization —
    together they pin every non-searched parameter when a study restricts
    the searched stacks (``ParameterSet.restrict``)."""
    name: str
    n_npus: int
    device: Device
    base_defaults: Mapping[str, Any] = field(default_factory=dict)
    workload_defaults: Mapping[str, Any] = field(default_factory=dict)
    doc: str = ""

    def stack_defaults(self) -> dict[str, Any]:
        return {**self.base_defaults, **self.workload_defaults}


SYSTEM_REGISTRY: dict[str, SystemPreset] = {}


def register_system(preset: SystemPreset, *, replace: bool = False) -> SystemPreset:
    if not replace and preset.name in SYSTEM_REGISTRY:
        raise ValueError(f"system {preset.name!r} already registered")
    SYSTEM_REGISTRY[preset.name] = preset
    return preset


def get_system(system: "str | SystemPreset") -> SystemPreset:
    if isinstance(system, SystemPreset):
        return system
    try:
        return SYSTEM_REGISTRY[system]
    except KeyError:
        raise ValueError(f"unknown system {system!r}; "
                         f"known: {sorted(SYSTEM_REGISTRY)}") from None


def list_systems() -> dict[str, SystemPreset]:
    return dict(SYSTEM_REGISTRY)


# Paper Table 3: the three evaluation systems, with their Table-3 baseline
# stacks (previously duplicated across benchmarks/common.py call sites).
WORKLOAD_DEFAULTS = dict(dp=64, pp=1, sp=4, weight_sharded=1)

register_system(SystemPreset(
    "system1", 512, SYSTEM_1_DEVICE,
    base_defaults=dict(
        sched_policy="fifo", coll_algo=("ring", "ring", "ring", "rhd"),
        chunks=2, multidim_coll="baseline",
        topology=("ring", "ring", "ring", "switch"),
        npus_per_dim=(4, 4, 4, 8), bw_per_dim=(200, 200, 200, 50)),
    workload_defaults=WORKLOAD_DEFAULTS,
    doc="512-NPU TPU-v5p-class pod (paper Table 3, System 1)"))

register_system(SystemPreset(
    "system2", 1024, SYSTEM_2_DEVICE,
    base_defaults=dict(
        sched_policy="fifo", coll_algo=("ring", "direct", "ring", "rhd"),
        chunks=2, multidim_coll="baseline",
        topology=("ring", "fc", "ring", "switch"),
        npus_per_dim=(4, 8, 4, 8), bw_per_dim=(400, 200, 150, 100)),
    workload_defaults=WORKLOAD_DEFAULTS,
    doc="1024-NPU wafer-scale-class system (paper Table 3, System 2)"))

register_system(SystemPreset(
    "system3", 2048, SYSTEM_3_DEVICE,
    base_defaults=dict(
        sched_policy="fifo", coll_algo=("direct", "rhd", "ring", "ring"),
        chunks=2, multidim_coll="baseline",
        topology=("fc", "switch", "ring", "ring"),
        npus_per_dim=(8, 16, 4, 4), bw_per_dim=(450, 100, 50, 50)),
    workload_defaults=WORKLOAD_DEFAULTS,
    doc="2048-NPU H100-class cluster (paper Table 3, System 3)"))


# -- assembly helpers (the former benchmarks/common.py make_env/make_pset) --

def system_pset(system: "str | SystemPreset", *,
                stacks: "set[str] | None" = None,
                max_pp: int = 4) -> ParameterSet:
    """The paper PsA sized for a system, optionally restricted to a stack
    subset with every pinned parameter defaulted from the preset."""
    preset = get_system(system)
    ps = paper_psa(preset.n_npus, max_pp=max_pp)
    if stacks is not None:
        ps = ps.restrict(stacks, preset.stack_defaults())
    return ps


def system_env(arch, system: "str | SystemPreset", *, batch: int = 1024,
               seq: int | None = None, objective="perf_per_bw",
               mode: str = "train", scenario=None,
               eval_store: dict | None = None, decode_tokens: int = 64,
               capacity_gb: float = 24.0, backend: str = "reference",
               sim_device: str | None = None):
    """A ``CosmicEnv`` over a registered system.  ``arch`` is an ``ARCHS``
    key or an ``ArchSpec``; ``seq`` defaults to the arch's max_seq;
    ``backend`` selects the simulation backend (``repro_torch.core.backends``)
    and ``sim_device`` where a torch backend runs (default: the card)."""
    from repro_torch.configs import ARCHS
    from repro_torch.core.env import CosmicEnv

    preset = get_system(system)
    spec = ARCHS[arch] if isinstance(arch, str) else arch
    return CosmicEnv(spec=spec, n_npus=preset.n_npus, device=preset.device,
                     scenario=scenario, batch=batch,
                     seq=seq or spec.max_seq, mode=mode,
                     decode_tokens=decode_tokens, objective=objective,
                     eval_store=eval_store, capacity_gb=capacity_gb,
                     backend=backend, sim_device=sim_device)
