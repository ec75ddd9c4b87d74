"""Multi-dimensional network fabrics from {Ring, Switch, FullyConnected}
building blocks (paper Fig. 3), with link counts and a LIBRA-style dollar
cost model for the Perf-per-Network-Cost reward.

Heterogeneous sub-partitions: a ``Cluster`` carves one physical fabric into
disjoint ``Partition``s (an NPU range + the sub-network it spans + its own
compute device), the substrate for multi-tenant DSE where each tenant owns a
slice of a possibly heterogeneous machine."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.cache import switchable_lru_cache

if TYPE_CHECKING:  # no runtime dep: compute.py never imports topology
    from repro_torch.core.compute import Device

TOPO_KINDS = ("ring", "switch", "fc")


@dataclass(frozen=True)
class TopoDim:
    kind: str            # ring | switch | fc
    npus: int            # NPUs along this dimension
    bw: float            # GB/s per link (paper's 'Bandwidth per Dim')
    latency_us: float = 0.5  # per-hop link latency

    def __post_init__(self):
        if self.kind not in TOPO_KINDS:
            raise ValueError(f"unknown topology kind {self.kind}")
        if self.npus < 2:
            raise ValueError("a network dimension needs >= 2 NPUs")

    # -- structural properties -------------------------------------------
    def links(self) -> int:
        """Physical links along this dim (per group of `npus`)."""
        n = self.npus
        if self.kind == "ring":
            return n                      # unidirectional ring of n links
        if self.kind == "switch":
            return n                      # n NPU<->switch links
        return n * (n - 1) // 2           # fully connected

    def links_per_npu(self) -> int:
        if self.kind == "ring":
            return 2                      # tx+rx neighbours (bidirectional)
        if self.kind == "switch":
            return 1
        return self.npus - 1

    def bisection_bw(self) -> float:
        n = self.npus
        if self.kind == "ring":
            return 2 * self.bw
        if self.kind == "switch":
            return (n // 2) * self.bw
        return (n // 2) * (n - n // 2) * self.bw / 1.0


@dataclass(frozen=True)
class Network:
    dims: tuple[TopoDim, ...]

    @property
    def n_npus(self) -> int:
        n = 1
        for d in self.dims:
            n *= d.npus
        return n

    def describe(self) -> str:
        return " x ".join(f"{d.kind}({d.npus})@{d.bw}GB/s" for d in self.dims)

    # -- LIBRA-style dollar cost ------------------------------------------
    # $/ (GB/s) per link, by technology tier: dim 0 is the cheapest
    # (on-board electrical), outer dims get progressively more expensive
    # (optical / switched fabrics).  Switch ports add a fixed premium.
    _LINK_COST_PER_GBPS = (1.0, 2.0, 6.0, 12.0)
    _SWITCH_PREMIUM = 1.5  # switched dims pay for the switch silicon

    def dollar_cost(self) -> float:
        total = 0.0
        n = self.n_npus
        for i, d in enumerate(self.dims):
            tier = self._LINK_COST_PER_GBPS[min(i, len(self._LINK_COST_PER_GBPS) - 1)]
            n_groups = n // d.npus      # how many parallel copies of this dim
            cost = d.links() * d.bw * tier
            if d.kind == "switch":
                cost *= self._SWITCH_PREMIUM
            total += cost * n_groups
        return total

    def bw_per_npu(self) -> float:
        """Sum of per-dim bandwidth allocated to each NPU (the paper's
        'BW per NPU' regularizer denominator)."""
        return sum(d.bw for d in self.dims)


@switchable_lru_cache(maxsize=8192)
def _build_network_cached(topology: tuple, npus_per_dim: tuple,
                          bw_per_dim: tuple, latency_us: tuple) -> Network:
    dims = tuple(
        TopoDim(t, int(n), float(b), float(l))
        for t, n, b, l in zip(topology, npus_per_dim, bw_per_dim, latency_us)
    )
    return Network(dims)


def build_network(topology: Sequence[str], npus_per_dim: Sequence[int],
                  bw_per_dim: Sequence[float],
                  latency_us: Sequence[float] | float = 0.5) -> Network:
    if isinstance(latency_us, (int, float)):
        latency_us = (float(latency_us),) * len(topology)
    # memoized: a search population re-resolves the same handful of fabric
    # configs every generation (Network is frozen, so sharing is safe)
    return _build_network_cached(tuple(topology), tuple(npus_per_dim),
                                 tuple(bw_per_dim), tuple(latency_us))


def carve_dims(dims: Sequence[TopoDim], caps: list[int],
               need: int) -> list[tuple[int, TopoDim]]:
    """THE carving rule: gcd-take ``need`` NPUs from ``dims`` innermost
    first, consuming the (mutated) per-dim capacities ``caps``; a residual
    factor no dim covers becomes a virtual dim at the outermost — slowest —
    tier's speed so its traffic is never free.  Each carved dim is returned
    as ``(source_dim_index, TopoDim)`` so callers can resolve per-physical-
    dim configuration (e.g. the Collective stack's per-dim algorithm knob)
    against the dim the traffic actually rides; residual virtual dims carry
    the outermost dim's index.  Shared by ``sub_network`` (partition
    fabrics) and ``simulator.group_dims`` (parallelism-group mapping) so
    the two can't diverge."""
    out: list[tuple[int, TopoDim]] = []
    for i, d in enumerate(dims):
        if need <= 1:
            break
        if caps[i] <= 1:
            continue
        take = math.gcd(need, caps[i])
        if take <= 1:
            continue
        out.append((i, TopoDim(d.kind, take, d.bw, d.latency_us)))
        caps[i] //= take
        need //= take
    if need > 1 and dims:
        last = dims[-1]
        out.append((len(dims) - 1, TopoDim(last.kind, need, last.bw,
                                           last.latency_us)))
    return out


def sub_network(net: Network, n: int) -> Network:
    """The sub-fabric a contiguous group of ``n`` NPUs spans (see
    ``carve_dims``), so a partition's collectives see the link tiers its
    NPUs would actually occupy."""
    return sub_network_indexed(net, n)[0]


def sub_network_indexed(net: Network, n: int) -> tuple[Network, tuple[int, ...]]:
    """``sub_network`` plus each sub-dim's source physical dim index, so
    multi-pool simulations can resolve per-physical-dim configuration (the
    Collective stack's per-dim algorithms) against the parent fabric's dims
    instead of the sub-fabric's positions."""
    carved = carve_dims(net.dims, [d.npus for d in net.dims], n)
    return (Network(tuple(d for _, d in carved)),
            tuple(i for i, _ in carved))


@dataclass(frozen=True)
class Partition:
    """A disjoint slice of a cluster: NPUs [offset, offset+n_npus), the
    sub-network they span, and the compute device installed there (per-
    partition devices are what makes a cluster heterogeneous)."""
    name: str
    offset: int
    n_npus: int
    network: Network
    device: "Device"

    def npu_range(self) -> tuple[int, int]:
        return (self.offset, self.offset + self.n_npus)

    def describe(self) -> str:
        lo, hi = self.npu_range()
        return f"{self.name}: npus[{lo}:{hi}) {self.device.name} {self.network.describe()}"


@dataclass(frozen=True)
class Cluster:
    """Disjoint partitions of one physical fabric (multi-tenant substrate)."""
    partitions: tuple[Partition, ...]
    total_npus: int

    def describe(self) -> str:
        return " | ".join(p.describe() for p in self.partitions)


def partition_cluster(net: Network, sizes: Sequence[int],
                      devices: Sequence["Device"],
                      names: Sequence[str] | None = None) -> Cluster:
    """Carve ``net`` into disjoint partitions of ``sizes[i]`` NPUs with
    ``devices[i]`` installed.  Raises if the sizes oversubscribe the fabric —
    callers that search partition sizes gate that to reward 0 instead."""
    if len(sizes) != len(devices):
        raise ValueError(f"{len(sizes)} partition sizes but "
                         f"{len(devices)} devices")
    if sum(sizes) > net.n_npus:
        raise ValueError(f"partitions {list(sizes)} oversubscribe "
                         f"{net.n_npus}-NPU cluster")
    parts = []
    off = 0
    for i, (n, dev) in enumerate(zip(sizes, devices)):
        name = names[i] if names else f"part{i}"
        parts.append(Partition(name, off, n, sub_network(net, n), dev))
        off += n
    return Cluster(tuple(parts), net.n_npus)


# -- the paper's Table 3 systems -------------------------------------------

def system_1() -> Network:
    """512 TPUv5p-like: [RI, RI, RI, SW], 4x4x4x8, [200,200,200,50]."""
    return build_network(("ring", "ring", "ring", "switch"), (4, 4, 4, 8),
                         (200, 200, 200, 50))


def system_2() -> Network:
    """1,024 NPUs 4D (Themis-like): [RI, FC, RI, SW], 4x8x4x8."""
    return build_network(("ring", "fc", "ring", "switch"), (4, 8, 4, 8),
                         (375, 175, 150, 100))


def system_3() -> Network:
    """2,048 H100-like: [FC, SW, RI, RI], 8x16x4x4."""
    return build_network(("fc", "switch", "ring", "ring"), (8, 16, 4, 4),
                         (900, 100, 50, 12.5))


def tpu_v5e_pod() -> Network:
    """Our dry-run target: 16x16 pod, 2D torus-ish ICI at ~50 GB/s/link."""
    return build_network(("ring", "ring"), (16, 16), (50, 50), latency_us=0.3)
