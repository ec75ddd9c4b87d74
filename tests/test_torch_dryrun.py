"""The dry run on a fake world, its attribution, the kernels' fake paths,
the cost-analysis copy, the bridge and the ``SPEC`` modules, on the CPU.

Dry run.  ``repro_torch.launch.dryrun.run_cell`` on reduced qwen2, mamba2,
gemma3 and granite-moe, each at a small train, prefill and decode shape
(batch 32, sequence 64) on the 256-rank ``pod`` mesh, reduced mamba2 and
jamba at a batch-1 decode shape (``d1``: 'data' splits no rows), gemma3's
decode on the 512-rank ``multipod`` mesh, reduced granite-moe and moonshot at
train_4k's own shape (batch 256, sequence 4096: several routing groups a
rank) and full-size qwen2-1.5b train_4k, in a subprocess holding a fake
world of 512 ranks (labels ``cpu``: this host's PyTorch has no CUDA),
against the JAX package's ``run_cell`` on the same spec and shapes (its
``get_arch`` and ``SHAPES`` replaced) in a subprocess of its own with 512
forced host devices.  Held:
  * ``status``, ``params``, ``active_params``, ``model_flops``, ``n_chips``
    equal;
  * ``kv_cache_bytes_per_device`` equal but for the ring caches' ``kpos``
    (int32 in the port, bf16 in the JAX package: 2 bytes a slot more);
  * ``argument_bytes`` equal but for ``kpos`` and for the inputs the JAX
    program never reads, which XLA drops from its entry parameters: the
    caches prefill rebuilds from nothing (Mamba's conv and SSM states, the
    ring caches) and decode's position in a model without attention
    (mamba2).  The port's prefill writes those caches in place, so they are
    its inputs;
  * ``flops_per_device`` within ``FLOP_BAND`` of XLA's: the port counts
    matrix products and its kernels (flash at 4 hd a pair, 10 hd backward;
    the SSD scan's chunked products, the intra-chunk scores among them, as
    XLA counts those of the JAX ``ssd_chunked``), XLA also one per element
    of every elementwise op (decode sits near 0.9) and counts remat
    recompute as the port does.  The port keeps split what the JAX plan
    splits (the vocabulary of the embedding and the loss, the query
    sequence of an attention whose heads do not divide 'model', the experts
    or their ff columns, the SSD scan's head_dim where its heads do not
    divide 'model', mamba's d_inner through its gated norm and its head
    view, the FSDP-split weights where moving the activations costs less,
    an undivided vocabulary of the head over an idle 'model'), so no rank
    does a gathered dim's work.  A batch-1 decode of a Mamba model (reduced
    mamba2 and jamba ``d1``: 'data' splits no rows) is held to the band on
    the decode conv's whole-row branch (``mamba._conv_whole_rows``, forced
    in a run of its own), whose layout XLA's count follows (mamba2 0.98x of
    XLA's FLOPs and 0.52x of its all-gather bytes, jamba 0.52x and 0.23x);
    the conv's d_inner split, the path the plan takes, is held to that run
    exactly: its FLOPs lower by the d_inner channels a rank no longer
    repeats (2 B cw (d_inner - d_inner / n) a layer; 0.54x of XLA's for
    mamba2), no all-gather at all, and fewer collective bytes in all
    (the cache's pieces and the head view move by all-to-all).  Reduced
    mamba2's train step sat at 1.07x only because its
    gathered d_inner made every 'model' rank repeat the output projection's
    gradient products; kept split, with the SSD formula counting the
    recurrence alone, it read 0.60x, and with the chunked products 0.93x
    (prefill 1.16x).  Two kinds of cell sit below 0.8 because the port's
    rank 0 does less than XLA counts for a device (``FLOP_FLOORS``): a
    prefill whose attention splits the query sequence, where rank 0 holds
    the first rows, the fewest pairs under the causal mask, and XLA counts
    the dense block of its rows against every key (qwen2 0.78, gemma3
    0.50); and MoE, where the port dispatches by index (XLA counts the JAX
    module's one-hot dispatch and combine contractions) and runs its share
    of the ff columns, or its own groups through whole experts (granite
    0.07 to 0.72, jamba's batch-1 decode 0.61);
  * the all-gather bytes a device within ``GATHER_BAND`` of XLA's.  A
    block's input is gathered along the sequence once for its products, a
    microbatch keeps its rows split, and the MoE gathers its experts' ff
    columns where that costs less than every rank routing every row: before
    these, full-size qwen2 train_4k gathered 1.89x XLA's bytes, reduced
    moonshot and granite train_4k 2.06x and 1.30x.  Full-size qwen2
    train_4k now sets the top (1.09x), reduced granite's prefill the bottom
    (0.17x).  At the reduced decode shapes the f32 score row that decode's
    softmax once gathered is small (those cells sat at 0.24 to 0.79x
    before), so ``--attribute`` on reduced qwen2 at decode_32k's shape
    holds the split softmax instead: no all-gather at the lines of
    decode's attention, the row's max and sum all-reduced there;
  * full-size qwen2-1.5b train_4k: the peak a device within twice XLA's
    (``PEAK_FACTOR``), which a gathered vocabulary (93 GiB against 4.6)
    would break;
  * one hand-computed case pins the per-device count: (4096 x 8192) @
    (8192 x 8192) split rows over 'data' and columns over 'model' of a
    (16, 16) mesh is 2 * 256 * 8192 * 512 FLOPs on rank 0, where
    ``FlopCounterMode`` over the ``DTensor`` ops counts the global 256x.

Attribution.  ``--attribute`` on reduced qwen2 at train_4k's shape: a
backward op is labelled by its node's forward site, and each collective
kind's bytes by site add up to its total; at decode_32k's shape (its 2 KV
groups do not divide 'model', so kv_seq splits there) the collectives at
the lines of decode's attention.
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import flash_attention as fa, ref, rmsnorm as rn, ssd_scan as ss
from repro_torch.models import model as M
from repro_torch.parallel.sharding import ShardingPlan

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 600  # seconds, per subprocess: each takes about 150 s here
SHAPES = {"t": (64, 32, "train"), "p": (64, 32, "prefill"), "d": (64, 32, "decode"),
          "d1": (64, 1, "decode"), "train_4k": (4096, 256, "train")}
ARCH_CELLS = ("qwen2-1.5b", "mamba2-130m", "gemma3-1b", "granite-moe-3b-a800m")
FULL_SIZE = ("qwen2-1.5b", "train_4k", "pod")  # the one cell run at full width and depth
CELLS = [(a, s, "pod") for a in ARCH_CELLS for s in "tpd"] + [("gemma3-1b", "d", "multipod")] + [
    (a, "d1", "pod") for a in ("mamba2-130m", "jamba-v0.1-52b")] + [
    (a, "train_4k", "pod") for a in ("granite-moe-3b-a800m", "moonshot-v1-16b-a3b")] + [FULL_SIZE]
FLOP_BAND = (0.8, 1.4)
FLOP_FLOORS = {"split_attention_prefill": 0.45, "moe": 0.05}  # below FLOP_BAND: see above
GATHER_BAND = (0.1, 1.1)  # the port's all-gather bytes a device over XLA's
WHOLE_ROWS = [(a, "d1", "pod") for a in ("mamba2-130m", "jamba-v0.1-52b")]  # see above
PEAK_FACTOR = 2.0
POD = {"data": 16, "model": 16}
MULTIPOD = {"pod": 2, "data": 16, "model": 16}

_SETUP = """
import json, sys
from pathlib import Path
from {pkg}.configs import ShapeSpec, get_arch, reduced
from {pkg}.launch import dryrun as D
D.SHAPES = {{n: ShapeSpec(n, *v) for n, v in {shapes!r}.items()}}
"""

PORT = _SETUP + """
import torch
from torch.utils.flop_counter import FlopCounterMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.core.bridge import MeshPlan
from repro_torch.models.layers import fake_mode
D.init_fake_world(512)
mesh = D.make_production_mesh(device="cpu")
with fake_mode():
    a = distribute_tensor(torch.empty(4096, 8192), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    b = distribute_tensor(torch.empty(8192, 8192), mesh, [Replicate(), Shard(1)],
                          src_data_rank=None)
    cost, whole = D.LocalCost(), FlopCounterMode(display=False)
    with cost:
        a @ b
    with whole:
        a @ b
m = MeshPlan((2, 16, 16), ("pod", "data", "model"), True, True).make_mesh(device="cpu")
print("PIN " + json.dumps(dict(local=cost.flops, flop_counter=whole.get_total_flops(),
                               mesh=[list(m.mesh_dim_names), list(m.shape)])))
from repro_torch.models import mamba
own_columns = mamba._conv_own_columns
for cell in sys.argv[2:]:
    arch, shape, mesh_kind, size, *whole_rows = cell.split(":")
    spec = get_arch(arch) if size == "full" else reduced(get_arch(arch))
    # decode's conv forced onto its whole-row branch
    mamba._conv_own_columns = (lambda *a: None) if whole_rows else own_columns
    rec = D.run_cell(arch, shape, mesh_kind, D.default_knobs(arch, shape), Path(sys.argv[1]),
                     device="cpu", spec=spec, tag="__whole_rows" if whole_rows else "")
    print(("WHOLE " if whole_rows else "REC ") + json.dumps(rec))
"""

JAX = _SETUP + """
whole_arch = get_arch
for cell in sys.argv[2:]:
    arch, shape, mesh_kind, size = cell.split(":")
    D.get_arch = whole_arch if size == "full" else (lambda name: reduced(whole_arch(name)))
    rec = D.run_cell(arch, shape, mesh_kind, D.default_knobs(arch, shape), Path(sys.argv[1]))
    print("REC " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """(the port's records, the JAX package's, the pinned case, the port's
    ``WHOLE_ROWS`` cells on the conv's whole-row branch), by cell; both
    subprocesses run at once."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    cells = [":".join(c + ("full" if c == FULL_SIZE else "reduced",)) for c in CELLS]
    whole_rows = [":".join(c + ("reduced", "whole_rows")) for c in WHOLE_ROWS]
    procs = {}
    for name, pkg, script, extra in (("port", "repro_torch", PORT, whole_rows),
                                     ("jax", "repro", JAX, [])):
        code = script.format(pkg=pkg, shapes=SHAPES)
        out = tmp_path_factory.mktemp(name)
        procs[name] = subprocess.Popen([sys.executable, "-c", code, str(out), *cells, *extra],
                                       env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    res = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, stderr[-4000:]
        recs = [json.loads(line[4:]) for line in stdout.splitlines() if line.startswith("REC ")]
        res[name] = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
        if name == "port":
            res["pin"] = next(json.loads(line[4:]) for line in stdout.splitlines()
                              if line.startswith("PIN "))
            res["whole_rows"] = {(r["arch"], r["shape"], r["mesh"]): r for r in (
                json.loads(line[6:]) for line in stdout.splitlines()
                if line.startswith("WHOLE "))}
    return res


def _local_bytes(spec, axis_sizes, b, s, keep) -> int:
    """Rank 0's bytes of the cache leaves ``keep(layer def, leaf name)``
    picks: bf16, kpos int32, split by the plan's spec."""
    plan = ShardingPlan(axis_sizes=axis_sizes)
    total = 0
    for ld, layer in zip(spec.layer_defs(), M.cache_defs(spec, b, s)):
        for name, d in layer.items():
            if not keep(ld, name):
                continue
            n = 1
            for size, entry in zip(d.shape, plan.spec(d.axes, d.shape) + (None,) * len(d.shape)):
                names = (entry,) if isinstance(entry, str) else (entry or ())
                n *= size // int(np.prod([axis_sizes[a] for a in names]))
            total += n * (4 if name == "kpos" else 2)
    return total


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ":".join(c))
def test_dryrun_record_matches_jax_run_cell(records, cell):
    arch, shape, mesh_kind = cell
    port, jax_rec = records["port"][cell], records["jax"][cell]
    assert port["status"] == jax_rec["status"] == "ok", port.get("error")
    for key in ("params", "active_params", "model_flops", "n_chips"):
        assert port[key] == jax_rec[key], key
    assert port["counted_by"] == "torch" and port["lower_s"] > 0
    spec = ARCHS[arch] if cell == FULL_SIZE else reduced(ARCHS[arch])
    b, s = SHAPES[shape][1], SHAPES[shape][0]
    sizes = MULTIPOD if mesh_kind == "multipod" else POD
    # kpos: 4 bytes a slot against 2
    kpos = _local_bytes(spec, sizes, b, s, lambda ld, name: name == "kpos") // 2
    extra = {"train": 0, "decode": kpos,
             # what the JAX prefill rebuilds from nothing (kpos among it)
             "prefill": _local_bytes(spec, sizes, b, s, lambda ld, name: ld.mixer != "attn_full")}
    extra = extra[port["kind"]]
    if port["kind"] == "decode" and all(ld.mixer == "mamba" for ld in spec.layer_defs()):
        extra += 4  # the position, which no layer reads
    mem, jmem = port["memory"], jax_rec["memory"]
    assert mem["argument_bytes"] == jmem["argument_bytes"] + extra
    if port["kind"] != "train":
        assert mem["kv_cache_bytes_per_device"] == jmem["kv_cache_bytes_per_device"] + kpos
    assert mem["peak_bytes_per_device"] >= mem["argument_bytes"]
    banded = records["whole_rows"][cell] if cell in WHOLE_ROWS else port
    ratio = banded["hlo"]["flops_per_device"] / jax_rec["hlo"]["flops_per_device"]
    split_attention = spec.n_heads and not ShardingPlan(axis_sizes=sizes).can_shard(
        "q_heads", spec.n_heads)
    lo = (FLOP_FLOORS["moe"] if spec.n_experts else
          FLOP_FLOORS["split_attention_prefill"] if split_attention and port["kind"] == "prefill"
          else FLOP_BAND[0])
    assert lo <= ratio <= FLOP_BAND[1], ratio
    if cell == FULL_SIZE:
        assert mem["peak_bytes_per_device"] <= PEAK_FACTOR * jmem["peak_bytes_per_device"]
    gathers = [r["hlo"]["collective_bytes"].get("all-gather", 0) for r in (banded, jax_rec)]
    assert GATHER_BAND[0] * gathers[1] <= gathers[0] <= GATHER_BAND[1] * gathers[1], gathers
    if cell in WHOLE_ROWS:
        # the conv's d_inner split: each rank its d_inner / n columns and b's and c's whole
        repeated = 2 * b * spec.ssm_conv * (spec.d_inner - spec.d_inner // sizes["model"])
        layers = sum(ld.mixer == "mamba" for ld in spec.layer_defs())
        assert (port["hlo"]["flops_per_device"] ==
                banded["hlo"]["flops_per_device"] - layers * repeated)
        assert port["hlo"]["collective_bytes"].get("all-gather", 0) == 0
        assert (sum(port["hlo"]["collective_bytes"].values()) <
                sum(banded["hlo"]["collective_bytes"].values()))
    kinds = set(port["hlo"]["collective_bytes"])
    assert kinds and kinds == set(port["hlo"]["collective_counts"])
    assert {k.split("@")[0] for k in port["hlo"]["collective_by_group"]} == kinds
    assert all(int(k.split("@")[1]) in (2, 16, 32, 256, 512)
               for k in port["hlo"]["collective_by_group"])


def test_per_device_flops_are_rank_zeros_own(records):
    pin = records["pin"]
    assert pin["local"] == 2 * 256 * 8192 * 512
    assert pin["flop_counter"] == 256 * pin["local"]  # the global shapes
    assert pin["mesh"] == [["pod", "data", "model"], [2, 16, 16]]


def test_dryrun_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "mamba2-130m", "--shape", "long_500k", "--reduced", "--device", "cpu",
                        "--out", str(tmp_path)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads((tmp_path / "mamba2-130m__long_500k__pod.json").read_text())
    assert rec["status"] == "ok" and rec["n_chips"] == 256 and rec["kind"] == "decode"
    skipped = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                              "qwen2-1.5b", "--shape", "long_500k", "--reduced", "--device",
                              "cpu", "--out", str(tmp_path)], env=env, capture_output=True,
                             text=True, timeout=TIMEOUT)
    assert skipped.returncode == 0 and "-> skipped" in skipped.stdout


def test_dryrun_cli_attributes_counts_another_rank_and_compares(tmp_path):
    """``--attribute`` labels the FLOPs and the peak's storages by op and
    source line; ``--rank 15`` counts the last 'model' rank of the pod,
    whose rows of a sequence-split attention see the most keys (reduced
    qwen2's 4 heads do not divide 16), so it does more than rank 0 but the
    same products and collectives; ``--compare`` prints a cell's line
    against a reference directory's record."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
            "--shape", "prefill_32k", "--reduced", "--device", "cpu", "--out", str(tmp_path)]
    for extra in (["--attribute"], ["--rank", "15", "--tag", "rank15"]):
        r = subprocess.run(base + extra, env=env, capture_output=True, text=True, timeout=TIMEOUT)
        assert r.returncode == 0, r.stderr[-4000:]
    first, last = (json.loads((tmp_path / f"qwen2-1.5b__prefill_32k__pod{t}.json").read_text())
                   for t in ("", "__rank15"))
    assert "rank" not in first and last["rank"] == 15
    att = first["attribution"]
    flops = dict(att["flops_by_site"])
    assert sum(flops.values()) == first["hlo"]["flops_per_device"]
    assert any(k.startswith("flash_fwd@kernels/flash_attention.py") for k in flops)
    assert att["peak_bytes_by_site"] and all(v > 0 for _, v in att["peak_bytes_by_site"])
    assert last["hlo"]["flops_per_device"] > first["hlo"]["flops_per_device"]
    assert last["hlo"]["collective_bytes"] == first["hlo"]["collective_bytes"]
    ref = tmp_path / "ref"
    ref.mkdir()
    (ref / "qwen2-1.5b__prefill_32k__pod.json").write_text(json.dumps(first))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--out",
                        str(tmp_path), "--compare", str(ref)], env=env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.startswith("qwen2-1.5b:prefill_32k:pod ok / ok;") and "(1.00x)" in r.stdout


@pytest.fixture(scope="module")
def train_attribution(tmp_path_factory):
    """``--attribute`` on reduced qwen2 at train_4k's shape (batch 256,
    sequence 4096, two microbatches; its tied table)."""
    out = tmp_path_factory.mktemp("attribute")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
                        "--shape", "train_4k", "--reduced", "--device", "cpu", "--attribute",
                        "--out", str(out)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((out / "qwen2-1.5b__train_4k__pod.json").read_text())


def test_attribute_labels_a_backward_op_with_its_forward_site(train_attribution):
    """An op the autograd engine runs is labelled by its node's forward
    site: the products' gradients by the line of the forward product, and
    the tied embedding table's gradient by the line that hands the table to
    the lookup and the head (``model._table``), where
    ``torch.autograd.grad``'s own line labelled them all before."""
    att = train_attribution["attribution"]
    flops = dict(att["flops_by_site"])
    backward = [k for k in flops if k.endswith("(backward of MmBackward0)")]
    assert backward and all(k.split(" (")[0] in flops for k in backward)
    table = next(i for i, line in enumerate((ROOT / "src/repro_torch/models/model.py")
                                            .read_text().splitlines(), 1)
                 if 'grad_as_input(params["embed"])' in line)
    labels = [k for kind in att["collective_bytes_by_site"].values() for k, _ in kind]
    assert f"reduce_scatter_tensor@models/model.py:{table} (backward of _GradAsInputBackward)" \
        in labels
    assert not any(k.startswith("mm@train/") for k in flops)  # no product at the grad call


def test_decode_softmax_over_a_split_kv_seq_gathers_no_score_row(tmp_path):
    """Reduced qwen2 at decode_32k's shape (batch 128, 32,768 slots split 16
    ways over 'model'): each rank attends on its own slots, so no
    all-gather is labelled at the lines of decode's attention (the f32
    score row's was, 8 rows x 4 heads x 2048 slots a rank, gathered whole),
    and the row's max and sum are all-reduced there, a (8, 2, 2, 1) f32
    each a layer."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen2-1.5b",
                        "--shape", "decode_32k", "--reduced", "--device", "cpu", "--attribute",
                        "--out", str(tmp_path)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads((tmp_path / "qwen2-1.5b__decode_32k__pod.json").read_text())
    by_site = rec["attribution"]["collective_bytes_by_site"]
    from repro_torch.models import attention
    decode = set()
    for fn in (attention.attn_decode, attention._own_slots, attention.split_softmax):
        lines, first = inspect.getsourcelines(fn)
        decode |= {f"models/attention.py:{first + i}" for i in range(len(lines))}
    gathered = {k.split("@")[1] for k, _ in by_site.get("all-gather", [])}
    assert gathered and not gathered & decode
    reduced_there = [v for k, v in by_site["all-reduce"] if k.split("@")[1] in decode]
    layers = len(reduced(ARCHS["qwen2-1.5b"]).layer_defs())
    assert sum(reduced_there) == 2 * layers * 8 * 2 * 2 * 4


def test_attribute_collective_bytes_by_site_add_up(train_attribution):
    """Each collective kind's bytes by site (the top 15 and the rest under
    ``other sites``) add up to its ``collective_bytes``."""
    by_site = train_attribution["attribution"]["collective_bytes_by_site"]
    total = train_attribution["hlo"]["collective_bytes"]
    assert set(by_site) == set(total)
    for kind, sites in by_site.items():
        assert len(sites) <= 16 and sum(v for _, v in sites) == total[kind], kind


# -- the kernels' fake paths ----------------------------------------------------

def _refuse(*_, **__):
    raise AssertionError("reached")


@pytest.fixture()
def guarded(monkeypatch):
    """The ctypes entries and the dense plain versions raise if reached."""
    for mod, names in ((fa, ("_entry", "_bwd_entry", "flash_attention_plain")),
                       (rn, ("_bwd_entry", "_bind", "_off_card")),
                       (ss, ("_entry", "_bwd_entry", "ssd_scan_plain")),
                       (ref, ("attention_ref", "ssd_ref", "rmsnorm_ref"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    counts = [fa.flash_attention, fa.flash_attention_bwd, rn.rmsnorm, rn.rmsnorm_bwd,
              ss.ssd_scan, ss.ssd_scan_bwd]
    before = [f.launches for f in counts]
    yield
    assert [f.launches for f in counts] == before


@pytest.mark.parametrize("grad", [False, True])
def test_kernels_take_their_fake_path(guarded, grad):
    """Fake stand-ins labelled cpu go through the operators' fake
    implementations, forward and backward: the shapes of the kernels'
    outputs, and the FLOP formulas the docstrings state."""
    b, s, h, g, hd, w = 2, 100, 4, 2, 16, 16
    with FakeTensorMode():
        q = torch.empty(b, s, h, hd, requires_grad=grad)
        k = torch.empty(b, s, g, hd, requires_grad=grad)
        x = torch.empty(b * s, 64, requires_grad=grad)
        nw = torch.empty(64)
        xs = torch.empty(b, s, h, 16, requires_grad=grad)
        dt, a = torch.empty(b, s, h), torch.empty(h)
        bc = torch.empty(b, s, 1, 16)
        with FlopCounterMode(display=False) as fc:
            o = fa.flash_attention(q, k, k, window=w)
            y = rn.rmsnorm(x, nw)
            ys, st = ss.ssd_scan(xs, dt, a, bc, bc)
            if grad:
                (o.sum() + y.sum() + ys.sum() + st.sum()).backward()
    assert o.shape == q.shape and y.shape == x.shape
    assert ys.shape == xs.shape and st.shape == (b, h, 16, 16) and st.dtype == torch.float32
    pairs = fa.pairs(s, s, True, w)
    assert pairs == sum(min(i, w - 1) + 1 for i in range(s))
    passes = (1, 2.5) if grad else (1, 0)  # forward; backward: 10 hd against 4 hd
    flash = 4 * hd * b * h * pairs * sum(passes)
    norm = 4 * b * s * 64 * (1 + 2 * (passes[1] > 0))
    squares = 64 ** 2 + (s - 64) ** 2  # chunks of 64 and 36 rows
    scan = b * (h * (4 * s * 16 * 16 + 2 * squares * 16) + 1 * 2 * squares * 16) * (
        1 + 2 * (passes[1] > 0))
    assert fc.get_total_flops() == flash + norm + scan


def test_cuda_labelled_stand_ins_take_the_fake_path(guarded):
    with FakeTensorMode():
        q = torch.empty(1, 8, 2, 16, device="cuda")
        o = fa.flash_attention(q, q, q)
        y = rn.rmsnorm(torch.empty(4, 32, device="cuda"), torch.empty(32, device="cuda"))
    assert o.device.type == "cuda" and o.shape == q.shape and y.shape == (4, 32)


def test_real_cpu_tensors_take_the_plain_versions(monkeypatch):
    """A real CPU tensor never reaches an operator: the operators raise here,
    and the wrappers still give their plain versions' results."""
    for mod in (fa, rn, ss):
        monkeypatch.setattr(mod, "_fwd_op", _refuse)
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 12, 2, 16, generator=gen)
    torch.testing.assert_close(fa.flash_attention(q, q, q), fa.flash_attention_plain(q, q, q),
                               rtol=0, atol=0)
    x, w = torch.randn(6, 32, generator=gen), torch.randn(32, generator=gen)
    torch.testing.assert_close(rn.rmsnorm(x, w), ref.rmsnorm_ref(x, w), rtol=0, atol=0)
    xs, dt = torch.randn(1, 8, 2, 16, generator=gen), torch.rand(1, 8, 2, generator=gen)
    a, bc = -torch.rand(2, generator=gen), torch.randn(1, 8, 1, 16, generator=gen)
    for got, want in zip(ss.ssd_scan(xs, dt, a, bc, bc), ss.ssd_scan_plain(xs, dt, a, bc, bc)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_stand_ins_allocate_nothing():
    spec = reduced(ARCHS["jamba-v0.1-52b"])
    with FakeTensorMode():
        params = M.abstract_params(spec, torch.bfloat16, device="cpu")
        caches = M.abstract_caches(spec, 4, 32, device="cpu")
    leaves = []
    from repro_torch.models.layers import map_with_path
    map_with_path(lambda _, t: leaves.append(t), [params, caches])
    assert all(type(t).__name__ == "FakeTensor" for t in leaves)
    defs = M.model_param_defs(spec)
    assert params["embed"].shape == defs["embed"].shape and params["embed"].dtype == torch.bfloat16
    kpos = [c["kpos"] for c in caches if "kpos" in c]
    assert all(t.dtype == torch.int32 for t in kpos)


# -- the cost-analysis copy, the bridge, the SPEC modules ---------------------------

def test_hlo_analysis_copy_matches_the_jax_package():
    import jax
    import jax.numpy as jnp

    from repro.core import hlo_analysis as J
    from repro_torch.core import hlo_analysis as T
    from test_hlo import SHARDED_SNIPPET

    def scanned(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return y.sum()

    shapes = (jax.ShapeDtypeStruct((32, 64), jnp.float32),
              jax.ShapeDtypeStruct((5, 64, 64), jnp.float32))
    text = jax.jit(scanned).lower(*shapes).compile().as_text()
    for src in (SHARDED_SNIPPET, text):
        got, want = T.HloCostModel(src).analyze(), J.HloCostModel(src).analyze()
        assert vars(got) == vars(want)
    assert T.COLLECTIVE_OPS == J.COLLECTIVE_OPS


def _designs(n=200, seed=0):
    from repro_torch.core.workload import Parallelism
    rng = np.random.default_rng(seed)
    out = [Parallelism(1024, dp=64, sp=4, pp=1, weight_sharded=True)]
    for _ in range(n):
        dp, sp, pp = (int(2 ** rng.integers(0, 5)) for _ in range(3))
        out.append(Parallelism(1024, dp=dp, sp=sp, pp=pp, weight_sharded=bool(rng.integers(2))))
    return out


def test_bridge_matches_the_jax_package():
    from repro.configs import ARCHS as JARCHS
    from repro.core import bridge as JB
    from repro.core.workload import Parallelism as JPar, generate_trace as j_trace
    from repro_torch.core import bridge as TB
    from repro_torch.core.hlo_analysis import CostTotals
    from repro_torch.core.workload import generate_trace

    for par in _designs():
        jpar = JPar(par.n_npus, par.dp, par.sp, par.pp, par.weight_sharded)
        assert TB.plan_from_design(par).__dict__ == JB.plan_from_design(jpar).__dict__
    rng = np.random.default_rng(1)
    for _ in range(50):
        sizes = {a: int(2 ** rng.integers(0, 5)) for a in ("pod", "data", "model", "pipe")
                 if rng.integers(2)}
        ws, sp = bool(rng.integers(2)), bool(rng.integers(2))
        got = TB.design_from_mesh(sizes, weight_sharded=ws, sp=sp)
        assert got.__dict__ == JB.design_from_mesh(sizes, weight_sharded=ws, sp=sp).__dict__
    rt = TB.design_from_mesh({"data": 16, "model": 16}, weight_sharded=True)
    assert rt.n_npus == 256 and rt.dp == 16 and rt.tp == 16
    par = _designs(0)[0]
    spec = ARCHS["qwen2-1.5b"]
    jspec = JARCHS["qwen2-1.5b"]
    trace = generate_trace(spec, par, batch=256, seq=4096)
    jtrace = j_trace(jspec, JPar(par.n_npus, par.dp, par.sp, par.pp, par.weight_sharded),
                     batch=256, seq=4096)
    for hlo_flops, coll in ((3.1e12, {"all-gather": 7e8, "reduce-scatter": 6e6}), (0.0, {})):
        t = CostTotals(flops=hlo_flops)
        jt = JB.CostTotals(flops=hlo_flops)
        for k, v in coll.items():
            t.collective_bytes[k] = jt.collective_bytes[k] = v
        got, want = TB.calibrate(trace, t, 256), JB.calibrate(jtrace, jt, 256)
        assert got.detail == want.detail
        np.testing.assert_equal([got.flops_ratio, got.coll_bytes_ratio],
                                [want.flops_ratio, want.coll_bytes_ratio])


def test_spec_modules_match_the_registry():
    import importlib

    from repro_torch.configs import registry
    mods = sorted(p.stem for p in (ROOT / "src" / "repro_torch" / "configs").glob("*.py")
                  if p.stem not in ("__init__", "base", "registry"))
    assert len(mods) == 14
    specs = {importlib.import_module(f"repro_torch.configs.{m}").SPEC for m in mods}
    assert specs == set(registry.ARCHS.values())
    for m in mods:
        jmod = importlib.import_module(f"repro.configs.{m}")
        assert importlib.import_module(f"repro_torch.configs.{m}").SPEC.name == jmod.SPEC.name


def test_quickstart_loop_on_the_port():
    """examples/quickstart.py's loop on the port: a GA search of the
    design space (fewer steps), the best design point as a mesh plan, then
    reduced qwen2 train steps whose loss falls."""
    from repro_torch.core.bridge import plan_from_design
    from repro_torch.core.compute import SYSTEM_1_DEVICE
    from repro_torch.core.dse import run_search
    from repro_torch.core.env import CosmicEnv
    from repro_torch.core.psa import paper_psa
    from repro_torch.core.workload import Parallelism
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import RunConfig, init_train_state, make_train_step

    env = CosmicEnv(spec=ARCHS["gpt3-13b"], n_npus=512, device=SYSTEM_1_DEVICE, batch=512,
                    seq=2048)
    res = run_search(paper_psa(512), env, "ga", steps=60, seed=0)
    cfg = res.best_config
    assert res.best_reward > 0
    par = Parallelism(512, cfg["dp"], cfg["sp"], cfg["pp"], bool(cfg["weight_sharded"]))
    plan = plan_from_design(par)
    assert int(np.prod(plan.shape)) == par.dp * par.sp * par.tp * par.pp
    spec = reduced(ARCHS["qwen2-1.5b"])
    run_cfg = RunConfig(remat="none", opt=OptConfig(lr=3e-3, warmup_steps=0))  # no warm-up
    state = init_train_state(spec, run_cfg, seed=0, device="cpu")
    step = make_train_step(spec, cfg=run_cfg)
    data = SyntheticLM(spec, DataConfig(global_batch=8, seq_len=64, seed=0))
    losses = []
    for i in range(8):
        state, metrics = step(state, data.batch_at(i))
        losses.append(metrics["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
