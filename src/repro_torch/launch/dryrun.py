"""Multi-pod dry run on a fake world: run every (arch x shape x mesh) cell.

Counterpart of the JAX package's ``launch/dryrun.py``.  For each cell it
starts PyTorch's ``"fake"`` process group as rank 0 (``--rank``: another)
of 256 (``pod``) or 512 (``multipod``) ranks in this process
(``launch/mesh.init_fake_world``), builds the production mesh and
``plan_for_mesh`` on it, makes stand-ins of every input under a
``FakeTensorMode`` (fake tensors labelled ``--device``: the card's ``cuda``
by default, or ``cpu``), distributes them by the plan, and
runs one train step (``make_train_step``), one prefill or one decode step of
the port itself, eagerly: the ``DTensor`` program every rank would run,
with rank 0's local shards.  Nothing is allocated and no kernel launches:
the three Hopper kernels take their operators' fake implementations
(``kernels/_library.py``), whatever the label.  While the step runs, a
dispatch mode below ``DTensor`` (``LocalCost``) sees rank 0's local ops and
counts their work.

The record keeps the JAX ``run_cell`` schema's keys (``arch``, ``shape``,
``mesh``, ``tag``, ``kind``, ``knobs``, ``params``, ``active_params``,
``status``, ``why``, ``n_chips``, ``model_flops``, ``error``/``traceback``),
with ``counted_by: "torch"`` and the run's seconds under ``lower_s``.  What
each kept key measures here, and how it differs from XLA's:
  * ``memory.argument_bytes``: the local shard bytes on rank 0 of every
    input (the state and batch, or params, inputs and caches, and decode's
    int32 position); XLA's entry parameters.  The ring caches' ``kpos`` is
    int32 here, bf16 there.
  * ``memory.peak_bytes_per_device``: the most bytes of local storage live
    at once while the step runs, its inputs included: each storage an op
    creates counts from its creation to its release (PyTorch's caching
    allocator and its fragmentation left out); XLA's is argument + output +
    temp - alias after buffer assignment.  The kernels' internal scratch
    (inside one operator call) is not seen.
  * ``memory.kv_cache_bytes_per_device``: the caches' local shard bytes, as
    the JAX dry run sums them (:182-187).
  * ``hlo.flops_per_device``: rank 0's local FLOPs by
    ``torch.utils.flop_counter``'s formulas (matrix products, convolutions)
    and the kernels' own (flash attention, RMSNorm, the SSD scan): only
    those ops.  XLA's HLO count adds one per element of every elementwise
    op, four per transcendental, and the reductions; both count remat's
    recompute.  ``FlopCounterMode`` over ``DTensor`` ops would count global
    shapes; ``LocalCost`` sits below them.
  * ``hlo.bytes_per_device``: the bytes each local op that is not a view
    reads and writes (eager execution, nothing fused); XLA's
    ``bytes_accessed`` is taken at fusion boundaries.
  * ``hlo.collective_bytes``, ``collective_counts``, ``collective_by_group``:
    each functional collective ``DTensor`` issues on rank 0, by the kind
    names of ``core.hlo_analysis.COLLECTIVE_OPS`` and its group's size,
    bytes being its output's (as the HLO count takes a collective's result
    type).  Where XLA picks its own collectives (and overlaps them),
    ``DTensor`` redistributes op by op.
Keys that only XLA fills (``compile_s``, ``xla_cost``, ``hlo_text_bytes``,
``unknown_trip_loops``, ``tpu_adjusted_peak``, and the memory analysis's
output, temp and alias bytes) are left out.

Results land in ``results/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json``
(``--out``).  ``--reduced`` runs the arch's ``reduced()`` config at the
cell's shape.  A process has one default group, so run the dry run in its
own process:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape train_4k --mesh pod [--device cpu] [--reduced]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import sys
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path

import torch
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ASSIGNED, SHAPES, cell_is_runnable, get_arch, reduced
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.layers import fake_mode, map_with_path
from repro_torch.parallel.sharding import _default_rules, distribute_tree, placements, plan_for_mesh
from repro_torch.serve.api import (decode_inputs_abstract, make_prefill_step, make_serve_step,
                                   prefill_inputs_abstract)
from repro_torch.train.train_step import (RunConfig, abstract_train_state, batch_abstract,
                                          batch_axes, make_train_step, train_state_axes)

# functional collectives -> the kind names of core.hlo_analysis.COLLECTIVE_OPS
_COLLECTIVES = {"all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
                "broadcast_": "collective-broadcast",
                "shard_dim_alltoall": "all-to-all"}  # DTensor's own (_dtensor::)


def _group_size(func, args) -> int:
    name = next(a for a in reversed(args) if isinstance(a, str))  # the group's name, last
    return _resolve_process_group(name).size()


def _in_sharding_propagation() -> bool:
    """Is ``DTensor`` running an op on global-shape stand-ins to learn its
    output's shape?  That run is none of rank 0's work."""
    f = sys._getframe(2)
    while f is not None:
        if "sharding_prop" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def _as_on_the_card():
    """Two of ``DTensor``'s choices made as on the card while a cell runs:
      * a strided shard's offsets come from splitting an index tensor and
        reading it back (``_StridedShard.local_shard_size_and_offset``):
        plain integer work that a ``FakeTensor`` cannot do, so it runs
        outside the fake mode;
      * a shard moved from one dim to another is an all-to-all
        (``_dtensor::shard_dim_alltoall``) on a card's group, an all-gather
        and a chunk on a CPU one, which gloo needs; the fake group takes
        the all-to-all whatever the label, so records labelled cpu and
        cuda count the same collectives."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types
    saved = []
    cls = getattr(placement_types, "_StridedShard", None)
    offsets = getattr(cls, "__dict__", {}).get("local_shard_size_and_offset")
    if callable(offsets):
        def outside_fake(*args, **kwargs):
            with unset_fake_temporarily():
                return offsets(*args, **kwargs)
        saved.append((cls, "local_shard_size_and_offset", offsets, outside_fake))
    alltoall = getattr(placement_types, "shard_dim_alltoall", None)
    if alltoall is not None and hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim,
                                                         mesh.get_group(mesh_dim).group_name)
        saved.append((placement_types, "shard_dim_alltoall", alltoall, all_to_all))
    for owner, name, _, patched in saved:
        setattr(owner, name, patched)
    try:
        yield
    finally:
        for owner, name, orig, _ in saved:
            setattr(owner, name, orig)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_FRAME = re.compile(r'File "([^"]*)", line (\d+)')


def _port_site(filename: str, line: int) -> str:
    """``file:line`` of a frame of the port past the dry run itself and the
    local-shard plumbing, else ``""``."""
    if "repro_torch" in filename and not filename.endswith(
            ("dryrun.py", "local_shards.py", "sharding.py", "_library.py")):
        return f"{filename.split('repro_torch/')[-1]}:{line}"
    return ""


def _node_site(node) -> str:
    """The port's innermost frame of an autograd node's forward traceback
    (anomaly mode's ``traceback_``), kept in the node's metadata once found;
    ``""`` without one."""
    meta = node.metadata
    if "site_" not in meta:
        frames = _FRAME.findall("".join(meta.get("traceback_", ())))
        meta["site_"] = next((s for s in (_port_site(f, int(n)) for f, n in reversed(frames))
                              if s), "")
    return meta["site_"]


class LocalCost(TorchDispatchMode):
    """Counts rank 0's local work while a ``DTensor`` program runs.

    A ``DTensor`` op is handed back (``NotImplemented``), so ``DTensor``
    desugars it into local ops and collectives on its local shards, which
    come back here and are counted: FLOPs by the registered formulas,
    bytes moved by ops that are not views, collectives by kind and group
    size, and the live bytes of every storage an op creates (``track``
    adds the inputs' own).  With ``attribute``, each storage, each FLOP
    count and each collective's bytes are also labelled with its op and the
    port's source line that called it, or for a backward op the line of its
    forward (``label``), and ``attribution()`` gives the FLOPs, the
    storages live at the peak (the live set is taken each time the peak
    rises by a 200th) and each collective kind's bytes by label."""

    def __init__(self, attribute: bool = False):
        super().__init__()
        self.attribute = attribute
        self._labels: dict[int, tuple[str, int]] = {}  # id(storage) -> (label, bytes)
        self.flops_by: dict[str, float] = defaultdict(float)
        self.peak_by: dict[str, int] = {}
        self._snap_at = 0
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.coll_counts: dict[str, float] = defaultdict(float)
        self.coll_by_group: dict[tuple[str, int], float] = defaultdict(float)
        self.coll_by_site: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self.live = self.peak = 0
        self._seen: weakref.WeakSet = weakref.WeakSet()

    def track(self, t: torch.Tensor, label: str = "input") -> None:
        """Count ``t``'s storage as live until it is released."""
        st = t.untyped_storage()
        if st in self._seen:
            return
        self._seen.add(st)
        n = st.nbytes()
        self.live += n
        key = id(st)
        if self.attribute:
            self._labels[key] = (label, n)
        if self.live > self.peak:
            self.peak = self.live
            if self.attribute and self.peak > self._snap_at * 1.005:
                self._snap_at = self.peak
                self.peak_by = defaultdict(int)
                for lab, nb in self._labels.values():
                    self.peak_by[lab] += nb
        weakref.finalize(st, self._release, n, key)

    def _release(self, n: int, key: int) -> None:
        self.live -= n
        self._labels.pop(key, None)

    @staticmethod
    def label(func) -> str:
        """``op@file:line``: the port's innermost frame that called ``func``
        (past the dry run itself and the local-shard plumbing).  An op that
        the autograd engine runs for a node, with no frame of the port
        between it and the engine (a ``DTensor`` op's backward, say), takes
        the node's forward site instead, ``op@file:line (backward of
        <node>)``: the port's innermost frame of the traceback that anomaly
        mode keeps with each node (``run_cell`` turns it on with
        ``attribute``).  Recompute under remat and a custom Function's own
        backward run frames of the port, and are labelled by those."""
        op, f = func.name().split("::")[-1], sys._getframe(1)
        while f is not None and f.f_code.co_name != "_engine_run_backward":
            site = _port_site(f.f_code.co_filename, f.f_lineno)
            if site:
                return f"{op}@{site}"
            f = f.f_back
        node = torch._C._current_autograd_node()  # also an engine thread's, which has no frames
        site = _node_site(node) if node is not None else ""
        return f"{op}@{site} (backward of {node.name()})" if site else op

    def attribution(self, top: int = 15) -> dict:
        """The FLOPs and the storages live at the peak by label, and each
        collective kind's bytes by label: the ``top`` largest, a
        collective's rest summed under ``other sites`` so that each kind
        adds up to its ``collective_bytes``."""
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        def with_rest(d):
            r = rank(d)
            rest = sum(d.values()) - sum(v for _, v in r)
            return r + [["other sites", rest]] if len(d) > top else r

        return {"peak_bytes_by_site": rank(self.peak_by), "flops_by_site": rank(self.flops_by),
                "collective_bytes_by_site": {k: with_rest(d) for k, d in self.coll_by_site.items()}}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace == "prim" or _in_sharding_propagation():
            return func(*args, **kwargs)
        registry = flop_counter.flop_registry
        if func._overloadpacket not in registry:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        label = self.label(func) if self.attribute else ""
        if packet in registry:
            f = registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            if self.attribute:
                self.flops_by[label] += f
        outs = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, torch.Tensor)]
        kind = (_COLLECTIVES.get(func.name().split("::")[-1].split(".")[0])
                if "c10d_functional" in func.namespace or func.namespace == "_dtensor" else None)
        if kind:
            b = sum(map(_nbytes, outs))
            self.coll_bytes[kind] += b
            self.coll_counts[kind] += 1
            self.coll_by_group[kind, _group_size(func, args)] += b
            if self.attribute:
                self.coll_by_site[kind][label] += b
        if not func.is_view:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.bytes += sum(map(_nbytes, ins + outs))
        for t in outs:
            self.track(t, label)
        return out


# Baseline per-cell run knobs (the paper-faithful starting point): the JAX
# package's, unchanged.  Hillclimb overrides are passed via --set key=value.
def default_knobs(arch: str, shape: str) -> dict:
    spec = get_arch(arch)
    knobs = {
        "remat": "full",
        "microbatches": 1,
        "fsdp": True,
        "sp": True,
        "donate": True,
    }
    # grad accumulation sized so the train_4k shape fits 16 GB HBM:
    # large models are dominated by per-microbatch activations + fp32 logits
    if shape == "train_4k":
        p = spec.param_count()
        if p > 4e10:
            knobs["microbatches"] = 8
        elif p > 1e10:
            knobs["microbatches"] = 4
        elif p > 5e9 or spec.vocab_size > 130_000:
            knobs["microbatches"] = 2
    return knobs


def _leaves(tree) -> list:
    out: list = []
    map_with_path(lambda _, t: out.append(t), tree)
    return out


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t) for t in _leaves(tree))


def _place(t, axes, plan, mesh):
    return distribute_tensor(t, mesh, placements(plan.spec(axes, tuple(t.shape)), mesh),
                             src_data_rank=None)


def run_cell(arch: str, shape_name: str, mesh_kind: str, knobs: dict, out_dir: Path,
             tag: str = "", *, device: str = "cuda", spec=None, attribute: bool = False,
             rank: int = 0) -> dict:
    """One cell on a fake world; writes and returns its record.  ``spec``
    replaces the registry's ``arch`` (a reduced config, say); ``attribute``
    adds ``LocalCost.attribution()`` under ``attribution``; ``rank``: whose
    local work is counted (the world's first cell fixes it for the process;
    under a causal mask a sequence-split attention gives rank 0 the fewest
    pairs and the last 'model' rank the most)."""
    spec = spec or get_arch(arch)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
        "kind": shape.kind, "knobs": dict(knobs),
        "params": spec.param_count(), "active_params": spec.active_param_count(),
        "counted_by": "torch", **({"rank": rank} if rank else {}),
    }
    if not cell_is_runnable(get_arch(arch), shape):
        rec["status"] = "skipped"
        rec["why"] = "long_500k requires a sub-quadratic mixer (see DESIGN.md)"
        _write(out_dir, rec)
        return rec

    multi = mesh_kind == "multipod"
    init_fake_world(512 if multi else 256, rank)
    mesh = make_production_mesh(multi_pod=multi, device=device)
    n_chips = mesh.size()
    # attn_dp / mamba_dp: replicate those weights over 'model' and compute
    # the mixer fully sequence-sharded; the optimizer state stays fully
    # sharded through a separate plan (JAX :98-113)
    rules = None
    drop = []
    if knobs.get("attn_dp"):
        drop += ["q_heads", "kv_heads"]
    if knobs.get("mamba_dp"):
        drop += ["d_inner", "ssm_heads"]
    if drop:
        rules = _default_rules(knobs["fsdp"], knobs["sp"])
        for k in drop:
            rules[k] = []
    plan = plan_for_mesh(mesh, fsdp=knobs["fsdp"], sp=knobs["sp"], rules=rules)
    plan_opt = plan_for_mesh(mesh, fsdp=True, sp=knobs["sp"]) if drop else plan
    if knobs.get("moe_group"):
        import repro_torch.models.moe as _moem
        _moem.GROUP_SIZE = int(knobs["moe_group"])
    cfg = RunConfig(compute_dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                    remat=knobs["remat"], microbatches=knobs["microbatches"],
                    loss_chunk=knobs.get("loss_chunk", 0))
    b, s = shape.global_batch, shape.seq_len
    t0 = time.time()
    try:
        cost = LocalCost(attribute)
        with fake_mode(), _as_on_the_card():
            if shape.kind == "train":
                state_abs = abstract_train_state(spec, cfg, device=device)
                state_ax = train_state_axes(spec, cfg)
                state = {k: distribute_tree(state_abs[k], state_ax[k],
                                            plan_opt if k in ("m", "v", "master") else plan,
                                            mesh)
                         for k in state_abs}
                batch = distribute_tree(batch_abstract(spec, b, s, cfg.compute_dtype,
                                                       device=device),
                                        batch_axes(spec), plan, mesh)
                args = [state, batch]
                step = make_train_step(spec, plan, cfg, opt_plan=plan_opt if drop else None)
                run = lambda: step(state, batch)
            else:
                params = distribute_tree(M.abstract_params(spec, cfg.param_dtype, device=device),
                                         M.param_axes(spec), plan, mesh)
                caches = distribute_tree(
                    M.abstract_caches(spec, b, s, torch.bfloat16, device=device),
                    M.cache_axes(spec, b, s), plan, mesh)
                rec_caches = caches
                if shape.kind == "prefill":
                    inp = prefill_inputs_abstract(spec, b, s, cfg.compute_dtype, device=device)
                    inp = _place(inp, ("batch", None) if inp.ndim == 2 else ("batch", None, None),
                                 plan, mesh)
                    args = [params, inp, caches]
                    fn = make_prefill_step(spec, plan, cfg.compute_dtype)
                    run = lambda: fn(params, inp, caches)
                else:  # decode: one new token at the cache's last position
                    tok, pos = decode_inputs_abstract(spec, b, cfg.compute_dtype, device=device)
                    tok = _place(tok, ("batch",) if tok.ndim == 1 else ("batch", None), plan, mesh)
                    args = [params, caches, tok, pos]
                    fn = make_serve_step(spec, plan, cfg.compute_dtype)
                    run = lambda: fn(params, caches, tok, s - 1)
            for t in _leaves(args):
                cost.track(t.to_local() if isinstance(t, DTensor) else t)
            # anomaly mode keeps each autograd node's forward traceback for
            # LocalCost.label; its NaN checks would read fake tensors
            anomaly = (torch.autograd.set_detect_anomaly(True, check_nan=False) if attribute
                       else contextlib.nullcontext())
            with torch.set_grad_enabled(shape.kind == "train"), anomaly, cost:
                out = run()
            del out
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["memory"] = {"argument_bytes": _local_bytes(args),
                         "peak_bytes_per_device": cost.peak}
        if shape.kind in ("decode", "prefill"):
            rec["memory"]["kv_cache_bytes_per_device"] = _local_bytes(rec_caches)
        rec["hlo"] = {
            "flops_per_device": float(cost.flops),
            "bytes_per_device": float(cost.bytes),
            "collective_bytes": dict(cost.coll_bytes),
            "collective_counts": dict(cost.coll_counts),
            "collective_by_group": {f"{k}@{g}": v for (k, g), v in cost.coll_by_group.items()},
        }
        if attribute:
            rec["attribution"] = cost.attribution()
        rec["n_chips"] = n_chips
        tokens = b * (s if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        rec["model_flops"] = float(mult * spec.active_param_count() * tokens)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _write(out_dir, rec)
    return rec


def _write(out_dir: Path, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    status = rec["status"]
    extra = ""
    if status == "ok":
        gb = rec["memory"]["peak_bytes_per_device"] / 2**30
        extra = (f" mem/dev={gb:.2f}GiB flops/dev={rec['hlo']['flops_per_device']:.3e}"
                 f" coll/dev={sum(rec['hlo']['collective_bytes'].values()):.3e}B"
                 f" run={rec.get('lower_s')}s")
    elif status == "error":
        extra = " " + rec["error"][:160]
    print(f"[dryrun] {rec['arch']}:{rec['shape']}:{rec['mesh']}{tag} -> {status}{extra}", flush=True)


def compare(port_dir: Path, ref_dir: Path) -> list[str]:
    """One line per record of ``port_dir`` that ``ref_dir`` (the JAX dry
    run's results: ``python -m repro.launch.dryrun --out ref_dir``) also
    holds: both statuses, the peak GiB a device, FLOPs a device and their
    ratio, and the collective bytes by kind, the port's against the
    reference's."""
    lines = []
    for path in sorted(port_dir.glob("*.json")):
        ref_path = ref_dir / path.name
        if not ref_path.exists():
            continue
        p, r = (json.loads(f.read_text()) for f in (path, ref_path))
        cell = f"{p['arch']}:{p['shape']}:{p['mesh']}"
        if p["status"] != "ok" or r["status"] != "ok":
            lines.append(f"{cell} {p['status']} / {r['status']}")
            continue
        pk, rk = (x["memory"]["peak_bytes_per_device"] / 2**30 for x in (p, r))
        pf, rf = (x["hlo"]["flops_per_device"] for x in (p, r))
        pc, rc = (x["hlo"]["collective_bytes"] for x in (p, r))
        coll = {k: f"{pc.get(k, 0):.4g} / {rc.get(k, 0):.4g}" for k in sorted(set(pc) | set(rc))}
        lines.append(f"{cell} ok / ok; peak GiB {pk:.3f} / {rk:.3f} ({pk / rk:.2f}x); FLOPs "
                     f"{pf:.4g} / {rf:.4g} ({pf / rf:.2f}x); collective bytes {coll}")
    return lines


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all assigned)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--set", action="append", default=[],
                    help="knob override key=value (remat, microbatches, fsdp, sp, donate)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device label (default: the card's program)")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced() config at the cell's shape")
    ap.add_argument("--attribute", action="store_true",
                    help="record the FLOPs, the peak's storages and the collectives' bytes "
                         "by op and source line (a backward op by its forward's line)")
    ap.add_argument("--rank", type=int, default=0,
                    help="count this rank's local work (default 0); name the records with --tag")
    ap.add_argument("--compare", default=None, metavar="REF_DIR",
                    help="run nothing: print --out's records against the JAX dry run's in REF_DIR")
    args = ap.parse_args()
    if args.compare:
        print("\n".join(compare(Path(args.out), Path(args.compare))))
        return

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    out = Path(args.out)
    init_fake_world(512 if "multipod" in meshes else 256, args.rank)  # one world for every cell

    n_ok = n_err = 0
    for arch in archs:
        spec = reduced(get_arch(arch)) if args.reduced else None
        for shape in shapes:
            for mesh_kind in meshes:
                knobs = default_knobs(arch, shape)
                for kv in args.set:
                    k, v = kv.split("=", 1)
                    knobs[k] = (v if k == "remat"
                                else v.lower() in ("1", "true")
                                if k in ("fsdp", "sp", "donate", "attn_dp", "mamba_dp")
                                else int(v))
                rec = run_cell(arch, shape, mesh_kind, knobs, out, args.tag,
                               device=args.device, spec=spec, attribute=args.attribute,
                               rank=args.rank)
                n_ok += rec["status"] in ("ok", "skipped")
                n_err += rec["status"] == "error"
    print(f"[dryrun] done: {n_ok} ok/skipped, {n_err} errors", flush=True)
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
