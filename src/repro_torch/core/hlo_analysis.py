"""Loop-aware cost analysis of post-SPMD optimized HLO.

``compiled.cost_analysis()`` counts each ``while`` body ONCE, but a
scan-over-layers program keeps ~all of its FLOPs and every per-layer
collective inside while loops — so the stock numbers under-count a 95-layer
model by ~95x.  This module re-derives execution-weighted totals from
``compiled.as_text()``:

  * parses every computation + instruction (shapes, operands, attributes),
  * recovers trip counts of ``while`` loops from their condition
    computations (constant-bound counter compares, which is exactly what
    ``lax.scan`` lowers to),
  * walks the call graph multiplying per-computation costs by trip counts,
  * attributes FLOPs (dot contraction math from dimension_numbers),
    elementwise/transcendental op counts, bytes at fusion boundaries, and
    per-kind collective bytes with replica-group sizes.

The port's own copy of the JAX package's ``core/hlo_analysis.py``, unchanged
but for this note.  In the port, ``core/bridge.py`` calibrates the
simulator against a ``CostTotals``, and the dry run (``launch/dryrun.py``)
fills one from what it counts on the fake world (no HLO exists there);
the parser reads HLO text compiled elsewhere, as the JAX package's does.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2,
    "s32": 4, "u32": 4, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "token": 0, "opaque": 0,
}

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
)

# ops that are pure data movement / bookkeeping: no flops
_ZERO_FLOP = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "reshape", "transpose", "copy", "broadcast", "iota", "slice",
    "dynamic-slice", "dynamic-update-slice", "concatenate", "pad",
    "reverse", "gather", "scatter", "convert", "after-all", "custom-call",
    "partition-id", "replica-id", "optimization-barrier", "copy-start",
    "copy-done", "send", "recv", "send-done", "recv-done", "domain",
    "reduce-precision", "rng-bit-generator", "infeed", "outfeed",
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of a (possibly tuple) HLO type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_elems(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n
    return total


@dataclass
class Instruction:
    name: str
    type_str: str
    opcode: str
    operands: list[str]
    attrs: str


@dataclass
class Computation:
    name: str
    instructions: list[Instruction]
    by_name: dict[str, Instruction]


@dataclass
class CostTotals:
    flops: float = 0.0
    transcendentals: float = 0.0
    bytes_accessed: float = 0.0
    # fusion-optimistic HBM traffic: only ops that MUST touch HBM-resident
    # operands on TPU (dot/conv/gather/scatter/reduce/collectives); assumes
    # every elementwise chain fuses into its producer — the lower bound a
    # perfect TPU fusion pass would achieve.
    bytes_fused: float = 0.0
    collective_bytes: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    collective_counts: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # (kind, group_size) -> bytes, for link-level modeling
    collective_by_group: dict[tuple[str, int], float] = field(default_factory=lambda: defaultdict(float))

    def add(self, other: "CostTotals", mult: float = 1.0):
        self.flops += other.flops * mult
        self.transcendentals += other.transcendentals * mult
        self.bytes_accessed += other.bytes_accessed * mult
        self.bytes_fused += other.bytes_fused * mult
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v * mult
        for k, v in other.collective_counts.items():
            self.collective_counts[k] += v * mult
        for k, v in other.collective_by_group.items():
            self.collective_by_group[k] += v * mult

    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


_COMP_HEADER = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*\(")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*((?:\([^)]*\)|[\w\[\],\{\}\d]+?))\s+([\w\-]+)\((.*)$"
)


def parse_hlo(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for raw in text.splitlines():
        line = raw.rstrip()
        if not line:
            continue
        stripped = line.strip()
        if stripped.startswith("HloModule"):
            continue
        if cur is None:
            m = _COMP_HEADER.match(stripped)
            if m and stripped.endswith("{"):
                cur = Computation(m.group(1), [], {})
            continue
        if stripped == "}" or stripped.startswith("} "):
            comps[cur.name] = cur
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, type_str, opcode, rest = m.groups()
        # operand names: %name tokens inside the first (...) group
        depth, i, args = 1, 0, ""
        while i < len(rest) and depth > 0:
            ch = rest[i]
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    break
            args += ch
            i += 1
        attrs = rest[i + 1:]
        operands = re.findall(r"%([\w\.\-]+)", args)
        instr = Instruction(name, type_str, opcode, operands, attrs)
        cur.instructions.append(instr)
        cur.by_name[name] = instr
    return comps


def _called_comps(instr: Instruction) -> list[str]:
    """computation names referenced in attributes (calls/fusion/while)."""
    out = []
    for key in ("to_apply", "body", "condition", "calls", "branch_computations"):
        for m in re.finditer(key + r"=\{?%?([\w\.\-]+)", instr.attrs):
            out.append(m.group(1))
        m = re.search(key + r"=\{([^}]*)\}", instr.attrs)
        if m:
            out = out[:-1] if out else out
            for nm in re.findall(r"%?([\w\.\-]+)", m.group(1)):
                out.append(nm)
    return out


def _attr_comp(instr: Instruction, key: str) -> str | None:
    m = re.search(key + r"=%?([\w\.\-]+)", instr.attrs)
    return m.group(1) if m else None


def _dot_flops(instr: Instruction, comp: Computation) -> float:
    """2 * prod(lhs dims) * prod(rhs non-contracting, non-batch dims)."""
    lhs = comp.by_name.get(instr.operands[0]) if instr.operands else None
    rhs = comp.by_name.get(instr.operands[1]) if len(instr.operands) > 1 else None
    if lhs is None or rhs is None:
        return 2.0 * _shape_elems(instr.type_str)
    lhs_dims = _dims_of(lhs.type_str)
    rhs_dims = _dims_of(rhs.type_str)
    rc = _parse_dim_list(instr.attrs, "rhs_contracting_dims")
    rb = _parse_dim_list(instr.attrs, "rhs_batch_dims")
    lhs_prod = math.prod(lhs_dims) if lhs_dims else 1
    rhs_free = math.prod(
        [d for i, d in enumerate(rhs_dims) if i not in rc and i not in rb]) if rhs_dims else 1
    return 2.0 * lhs_prod * rhs_free


def _dims_of(type_str: str) -> list[int]:
    m = _SHAPE_RE.search(type_str)
    if not m or not m.group(2):
        return []
    return [int(d) for d in m.group(2).split(",")]


def _parse_dim_list(attrs: str, key: str) -> set[int]:
    m = re.search(key + r"=\{([\d,]*)\}", attrs)
    if not m or not m.group(1):
        return set()
    return {int(d) for d in m.group(1).split(",")}


_TRANSCENDENTAL = {"exponential", "log", "tanh", "rsqrt", "sqrt", "power",
                   "logistic", "sine", "cosine", "exponential-minus-one", "log-plus-one",
                   "erf", "cbrt", "atan2"}


class HloCostModel:
    """Execution-weighted cost walker over a parsed HLO module."""

    def __init__(self, text: str):
        self.comps = parse_hlo(text)
        self.text = text
        self._memo: dict[str, CostTotals] = {}
        self.entry = self._find_entry(text)
        self.unknown_trip_loops = 0

    def _find_entry(self, text: str) -> str:
        m = re.search(r"^ENTRY\s+%?([\w\.\-]+)", text, re.MULTILINE)
        if m:
            return m.group(1)
        m = re.search(r"entry_computation_name\s*=\s*\"?([\w\.\-]+)", text)
        return m.group(1) if m else next(iter(self.comps))

    # -- trip counts ------------------------------------------------------
    def trip_count(self, cond_name: str) -> int:
        cond = self.comps.get(cond_name)
        if cond is None:
            return 1
        best = None
        for ins in cond.instructions:
            if ins.opcode != "compare":
                continue
            direction = "LT"
            m = re.search(r"direction=(\w+)", ins.attrs)
            if m:
                direction = m.group(1)
            for opn in ins.operands:
                dep = cond.by_name.get(opn)
                if dep is None or dep.opcode != "constant":
                    continue
                lit = self._const_literal(cond_name, dep)
                if lit is None:
                    continue
                if direction == "LT":
                    best = lit
                elif direction == "GT":
                    best = lit
                elif direction in ("LE", "GE"):
                    best = lit + 1
        if best is None or best < 1:
            self.unknown_trip_loops += 1
            return 1
        return int(best)

    def _const_literal(self, comp_name: str, ins: Instruction) -> int | None:
        # the literal is inside the original text line: "constant(95)"
        pat = re.compile(r"%?" + re.escape(ins.name) + r"\s*=\s*\S+\s+constant\((-?\d+)\)")
        m = pat.search(self.text)
        return int(m.group(1)) if m else None

    # -- cost walk ---------------------------------------------------------
    def analyze(self, comp_name: str | None = None) -> CostTotals:
        comp_name = comp_name or self.entry
        if comp_name in self._memo:
            return self._memo[comp_name]
        comp = self.comps.get(comp_name)
        total = CostTotals()
        if comp is None:
            return total
        self._memo[comp_name] = total  # pre-insert to break cycles
        for ins in comp.instructions:
            op = ins.opcode
            if op == "while":
                body = _attr_comp(ins, "body")
                cond = _attr_comp(ins, "condition")
                # XLA annotates counted loops: backend_config={"known_trip_count":{"n":"8"},...}
                m = re.search(r'known_trip_count[^}]*?"n"\s*:\s*"(\d+)"', ins.attrs)
                if m:
                    trips = int(m.group(1))
                else:
                    trips = self.trip_count(cond) if cond else 1
                if body:
                    total.add(self.analyze(body), trips)
                if cond:
                    total.add(self.analyze(cond), trips)
            elif op == "conditional":
                for sub in re.findall(r"%?([\w\.\-]+)", ins.attrs.split("branch_computations=")[-1].split("}")[0]) \
                        if "branch_computations" in ins.attrs else []:
                    if sub in self.comps:
                        total.add(self.analyze(sub), 1.0)
                        break  # cost one branch
                total.bytes_accessed += _shape_bytes(ins.type_str)
            elif op in ("call", "fusion", "async-start"):
                sub = _attr_comp(ins, "to_apply") or _attr_comp(ins, "calls")
                if sub:
                    inner = self.analyze(sub)
                    t = CostTotals()
                    t.add(inner)
                    # bytes at the fusion boundary: operands + output
                    t.bytes_accessed = self._call_site_bytes(comp, ins)
                    total.add(t)
            elif op in ("reduce", "reduce-window", "sort", "map", "select-and-scatter"):
                sub = _attr_comp(ins, "to_apply")
                elems = sum(_shape_elems(comp.by_name[o].type_str)
                            for o in ins.operands if o in comp.by_name) or _shape_elems(ins.type_str)
                inner_flops = self.analyze(sub).flops if sub else 1.0
                total.flops += max(inner_flops, 1.0) * elems
                total.bytes_accessed += self._call_site_bytes(comp, ins)
                total.bytes_fused += self._call_site_bytes(comp, ins)
            elif op.startswith("all-") or op in ("reduce-scatter", "collective-permute", "collective-broadcast"):
                kind = op.replace("-start", "")
                if kind.endswith("-done"):
                    continue
                b = _shape_bytes(ins.type_str)
                gsz = self._group_size(ins)
                total.collective_bytes[kind] += b
                total.collective_counts[kind] += 1
                total.collective_by_group[(kind, gsz)] += b
                total.bytes_accessed += b
                total.bytes_fused += b
            elif op == "dot":
                total.flops += _dot_flops(ins, comp)
                total.bytes_accessed += self._call_site_bytes(comp, ins)
                total.bytes_fused += self._call_site_bytes(comp, ins)
            elif op == "convolution":
                # rough: 2 * output elems * (kernel elems)
                total.flops += 2.0 * _shape_elems(ins.type_str) * 8
                total.bytes_accessed += self._call_site_bytes(comp, ins)
                total.bytes_fused += self._call_site_bytes(comp, ins)
            elif op in ("gather", "scatter", "dynamic-update-slice", "dynamic-slice"):
                # slice-accurate accounting: a DUS/DS/gather/scatter touches
                # only the moved slice, not its whole operand buffer
                b = self._slice_bytes(comp, ins)
                total.bytes_accessed += b
                total.bytes_fused += b
            elif op in _ZERO_FLOP:
                if op in ("custom-call",):
                    b = self._call_site_bytes(comp, ins)
                    total.bytes_accessed += b
                    total.bytes_fused += b
            else:
                elems = _shape_elems(ins.type_str)
                if op in _TRANSCENDENTAL:
                    total.transcendentals += elems
                    total.flops += 4.0 * elems  # transcendental ~ a few flops
                else:
                    total.flops += elems
        return total

    def _slice_bytes(self, comp: Computation, ins: Instruction) -> float:
        if ins.opcode == "dynamic-update-slice" and len(ins.operands) >= 2:
            upd = comp.by_name.get(ins.operands[1])
            if upd is not None:
                return 2.0 * _shape_bytes(upd.type_str)  # read update, write region
        if ins.opcode == "scatter" and len(ins.operands) >= 3:
            upd = comp.by_name.get(ins.operands[2])
            if upd is not None:
                return 2.0 * _shape_bytes(upd.type_str)
        # dynamic-slice / gather: read + write ~ the extracted slice
        return 2.0 * _shape_bytes(ins.type_str)

    def _call_site_bytes(self, comp: Computation, ins: Instruction) -> float:
        b = _shape_bytes(ins.type_str)
        for o in ins.operands:
            dep = comp.by_name.get(o)
            if dep is not None:
                b += _shape_bytes(dep.type_str)
        return float(b)

    def _group_size(self, ins: Instruction) -> int:
        # replica_groups=[8,64]<=[...]  -> 64 per group ; or explicit {{0,1},{2,3}}
        m = re.search(r"replica_groups=\[(\d+),(\d+)\]", ins.attrs)
        if m:
            return int(m.group(2))
        m = re.search(r"replica_groups=\{\{([\d,]+)\}", ins.attrs)
        if m:
            return len(m.group(1).split(","))
        return 1


def analyze_compiled_text(text: str) -> CostTotals:
    return HloCostModel(text).analyze()
