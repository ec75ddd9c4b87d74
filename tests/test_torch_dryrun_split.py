"""The dry run of mamba2's kept d_inner split and of the fused NLL, on the CPU.

Attribution.  ``--attribute`` on reduced mamba2 at prefill_32k's shape on
the pod (d_inner 128 over 16 'model' ranks, its 8 heads of 16 on 16 ranks:
each rank scans one column of every head): no all-gather at the lines of
``ops.fused_rmsnorm`` but the norm weights' own FSDP gathers (at most every
norm weight's bytes), and none at the lines of mamba's head view and fold
(``_heads``, ``_to_head_dim``, ``_fold_heads``, ``_from_head_dim``); the
head view and the fold move by all-to-all there, and the gated norm's row
sums are all-reduced at the split-row Function's line
(``kernels/rmsnorm.py``).  On the parent tree the gated norm gathered
3.36e7 bytes at ``ops.py:93`` and the head view 3.36e7 at ``mamba.py:135``.
The same at decode_32k's shape: no all-gather at the lines of decode's
conv (``_conv_own_columns``, ``_conv_whole_rows``) or of the head view and
fold, and at ``mamba_decode``'s own lines none but w_out's FSDP gather (at
most its share over 'data'); the conv, the head view and the fold move by
all-to-all.  Before decode's conv kept the d_inner split it gathered each
row of its three streams whole at ``mamba_decode``'s concatenation.

Peak.  Reduced mamba2 with mamba2-130m's own vocabulary (50,280 words) at
train_4k's shape (batch 256, sequence 4096) on the pod, against the JAX
``run_cell`` of the same spec in a subprocess with 512 forced host devices:
the loss's logits (each rank's 16 rows of 256 positions) set the peak, and
the port's is within ``PEAK_FACTOR`` of XLA's.  Autograd of the plain loss
held five f32 copies of them in the backward (3.85 GiB against XLA's 2.36
on the parent tree, 1.63x); the fused NLL writes one buffer (1.93 GiB).
"""
from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import ops
from repro_torch.models import mamba

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT = 600  # seconds, per subprocess: each takes under 30 s here
PEAK_FACTOR = 1.1  # the port's peak over XLA's
VOCAB = 50_280  # mamba2-130m's
POD_MODEL = 16  # the pod's 'model' axis

CELL = """
import json, sys
from pathlib import Path
from {pkg}.configs import get_arch, reduced
from {pkg}.launch import dryrun as D
spec = reduced(get_arch("mamba2-130m"), vocab_size={vocab})
knobs = D.default_knobs("mamba2-130m", "train_4k")
if "{pkg}" == "repro":
    D.get_arch = lambda name: spec
    rec = D.run_cell("mamba2-130m", "train_4k", "pod", knobs, Path(sys.argv[1]))
else:
    D.init_fake_world(256)
    rec = D.run_cell("mamba2-130m", "train_4k", "pod", knobs, Path(sys.argv[1]), device="cpu",
                     spec=spec)
print("REC " + json.dumps(rec))
"""


def _lines(*fns):
    """The source lines of each function, as (file relative to the package, range)."""
    out = []
    for fn in fns:
        src, start = inspect.getsourcelines(fn)
        rel = inspect.getsourcefile(fn).split("repro_torch/")[-1]
        out.append((rel, range(start, start + len(src))))
    return out


def _at(label: str, spans) -> bool:
    site = label.split("@", 1)[-1].split(" ", 1)[0]
    path, _, line = site.rpartition(":")
    return any(path == rel and line.isdigit() and int(line) in lines for rel, lines in spans)


def _attributed(tmp_path_factory, shape: str) -> dict:
    out = tmp_path_factory.mktemp("attribute")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-130m",
                        "--shape", shape, "--reduced", "--device", "cpu", "--attribute",
                        "--out", str(out)], env=env, capture_output=True, text=True,
                       timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads((out / f"mamba2-130m__{shape}__pod.json").read_text())


@pytest.fixture(scope="module")
def prefill_record(tmp_path_factory):
    return _attributed(tmp_path_factory, "prefill_32k")


def test_mamba_norm_and_head_view_gather_no_d_inner_rows(prefill_record):
    by_site = prefill_record["attribution"]["collective_bytes_by_site"]
    gathers = dict(by_site["all-gather"])
    spec = reduced(ARCHS["mamba2-130m"])
    norm_weights = 2 * (spec.n_layers * (spec.d_model + spec.d_inner) + spec.d_model)  # bf16
    norm = sum(v for k, v in gathers.items() if _at(k, _lines(ops.fused_rmsnorm)))
    assert norm <= norm_weights, (norm, gathers)
    view = _lines(mamba._heads, mamba._to_head_dim, mamba._fold_heads, mamba._from_head_dim)
    assert not [k for k in gathers if _at(k, view)], gathers
    moved = [k for k, _ in by_site["all-to-all"] if _at(k, view)]
    assert any(_at(k, _lines(mamba._to_head_dim)) for k in moved), by_site["all-to-all"]
    assert any(_at(k, _lines(mamba._from_head_dim)) for k in moved), by_site["all-to-all"]
    assert any(k.startswith("all_reduce@kernels/rmsnorm.py") for k, _ in by_site["all-reduce"])


@pytest.fixture(scope="module")
def decode_record(tmp_path_factory):
    return _attributed(tmp_path_factory, "decode_32k")


def test_mamba_decode_conv_and_head_view_gather_no_d_inner_rows(decode_record):
    by_site = decode_record["attribution"]["collective_bytes_by_site"]
    gathers = dict(by_site["all-gather"])
    spec = reduced(ARCHS["mamba2-130m"])
    conv_view = _lines(mamba._conv_own_columns, mamba._conv_whole_rows, mamba._heads,
                       mamba._to_head_dim, mamba._fold_heads, mamba._from_head_dim)
    assert not [k for k in gathers if _at(k, conv_view)], gathers
    # at mamba_decode's own lines only w_out's FSDP share ('embed' over 'data'), bf16
    w_out = 2 * spec.n_layers * spec.d_inner // POD_MODEL * spec.d_model
    decode = sum(v for k, v in gathers.items() if _at(k, _lines(mamba.mamba_decode)))
    assert decode <= w_out, (decode, w_out, gathers)
    moved = [k for k, _ in by_site["all-to-all"]]
    for fn in (mamba._conv_own_columns, mamba._to_head_dim, mamba._from_head_dim):
        assert any(_at(k, _lines(fn)) for k in moved), (fn.__name__, by_site["all-to-all"])


def test_loss_backward_peak_within_a_factor_of_xla(tmp_path):
    procs = {}
    for pkg in ("repro_torch", "repro"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", CELL.format(pkg=pkg, vocab=VOCAB), str(tmp_path / pkg)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    recs = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, stderr[-4000:]
        recs[pkg] = next(json.loads(line[4:]) for line in stdout.splitlines()
                         if line.startswith("REC "))
        assert recs[pkg]["status"] == "ok", recs[pkg].get("error")
    port, xla = (recs[k]["memory"]["peak_bytes_per_device"] for k in ("repro_torch", "repro"))
    assert port <= PEAK_FACTOR * xla, (port / 2 ** 30, xla / 2 ** 30)
