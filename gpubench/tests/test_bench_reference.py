"""Each plain reference against the port's CPU path at reduced sizes: the
seeded weights, the forward, the loss and its gradients, serving's prefill
and decode, and AdamW."""
import numpy as np
import pytest
import torch

from gpubench import harness
from gpubench.reference import common
from gpubench.tests.conftest import SMALL


def setup(config: str, **arch):
    from repro_torch.configs.base import ArchSpec
    cfg = harness.config(config)
    a = {**cfg["arch"], **SMALL[config], **arch}
    return ArchSpec(**a), {**a, **cfg["model"]}, harness.reference(cfg["reference"])


def flat(tree):
    from repro_torch.train import optimizer as opt
    return opt.leaves(tree)


def batch(spec, b=2, s=64, seed=3):
    g = np.random.default_rng(seed)
    toks = g.integers(0, spec.vocab_size, size=(b, s + 1), dtype=np.int32)
    return {"inputs": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}


@pytest.fixture(params=["mamba2-130m", "granite-moe-3b-a800m"])
def model(request, monkeypatch):
    from repro_torch.models import moe
    # granite: a capacity that drops assignments, stated alike to both sides
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 0.5)
    spec, cfg, ref = setup(request.param)
    if "moe" in cfg:
        cfg["moe"] = {**cfg["moe"], "capacity_factor": 0.5}
    return spec, cfg, ref


def test_weights_from_the_seed_are_the_programs(model):
    from repro_torch.models import model as M
    spec, cfg, ref = model
    prog = flat(M.init_params(spec, 11, device="cpu"))
    mine = common.init_params(ref.param_defs(cfg), 11, "cpu")
    assert [tuple(p.shape) for p in prog] == [tuple(v.shape) for v in mine.values()]
    assert all(torch.equal(p, v) for p, v in zip(prog, mine.values()))


def test_forward_loss_and_gradients(model):
    from repro_torch.train.train_step import RunConfig, make_loss_fn
    from repro_torch.models import model as M
    spec, cfg, ref = model
    b = batch(spec)
    params = M.init_params(spec, 5, device="cpu")
    ps = flat(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = make_loss_fn(spec, cfg=RunConfig(remat="none", lb_weight=cfg["lb_weight"]))(params, b)
    grads = torch.autograd.grad(loss, ps)
    mine = common.init_params(ref.param_defs(cfg), 5, "cpu")
    for v in mine.values():
        v.requires_grad_(True)
    rl = ref.loss(mine, b, cfg)
    rg = torch.autograd.grad(rl, list(mine.values()))
    assert float(loss.detach()) == pytest.approx(float(rl.detach()), rel=1e-6)
    for (path, r), g in zip(zip(mine, rg), grads):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-6 * float(r.abs().max()) + 1e-9,
                                   msg=path)


def test_prefill_and_decode_logits(model):
    from repro_torch.models import model as M
    from repro_torch.serve.engine import Engine
    spec, cfg, ref = model
    params = M.init_params(spec, 9, device="cpu")
    eng = Engine(spec, params, max_len=72, dtype=torch.float32, device="cpu")
    kept = []

    def keeping(fn):
        def call(*a):
            out = fn(*a)
            kept.append(out[0])
            return out
        return call

    for name in ("_prefill", "_decode"):
        setattr(eng, name, keeping(getattr(eng, name)))
    prompts = batch(spec, s=64)["inputs"].numpy()
    out, _ = eng.generate(prompts, max_new=4)
    mine = common.init_params(ref.param_defs(cfg), 9, "cpu")
    seq = torch.as_tensor(np.concatenate([prompts, out], axis=1))
    with torch.no_grad():
        want = ref.served_logits(mine, seq, 64, list(range(63, 68)), cfg)
    torch.testing.assert_close(torch.stack(kept, dim=1), want, rtol=1e-4, atol=1e-5)


def test_adamw_is_the_programs():
    from repro_torch.train import optimizer as opt
    adamw = harness.traffic("train.b4s4096")["adamw"]
    g = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7, generator=g)}
    state = opt.init_state(params)
    mine = {k: v.clone() for k, v in params.items()}
    ref = common.AdamW(mine, adamw)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
        opt.apply_updates(state, {k: v.clone() for k, v in grads.items()},
                          opt.OptConfig(**adamw))
        ref.update(mine, grads)
    for k in params:
        torch.testing.assert_close(state["params"][k], mine[k], rtol=1e-6, atol=1e-8)
