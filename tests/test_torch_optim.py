"""PyTorch port, the whole optimizer factory on the CPU against the JAX one.

Every name of the JAX factory (sgd, adam, adamw, nadam, radam, adadelta,
rmsprop, rmsproptf, novograd, nvnovograd, lamb), with and without weight
decay (the decay mask as the port's parameter groups), with the
``lookahead_`` prefix, and the ``fused*`` aliases, over 5 steps on the
same seeded gradients with a changing lr (the scheduler's rewrite); the
lookahead rows over 7 steps, so one sync (every 6th step) is in them.
Every parameter within 1e-6 of its change over the run plus 2 f32 ulps of
its magnitude a step (``test_torch_train._close_change``).

radam's rectified branch (ρ_t ≥ 5, from step 6 at b2 = 0.999) is held
apart: ρ_t divides by ``1 - b2^t`` (0.006 at t = 6), so the one-ulp
difference between XLA's f32 ``pow`` on the CPU and torch's correctly
rounded one becomes 0.08% of ρ_t and 0.6% of the rectification factor r
at t = 6 (0.1% by t = 13).  That branch is held within 1% of the
rectified steps' change against the JAX chain, and the port's r within
1e-5 of r computed in float64 from the same f32 ``b2^t``.

Then, for each optimizer: the adamw/radam weight decay divided by the lr,
as the JAX factory does; every state tensor made at construction; a
checkpoint round trip (``state_dict`` through ``torch.save``) after 3
steps that continues bitwise as the uninterrupted optimizer; and a NaN
gradient through the guarded train step that leaves the whole state
(parameters, moments, counters, lookahead's slow copy) bitwise unchanged.
"""

import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepfake_detection_tpu.optim import create_optimizer as j_create_opt
from deepfake_detection_tpu_torch import losses as t_losses
from deepfake_detection_tpu_torch.optim import (Adadelta, Adam, Lamb,
                                                Lookahead, NovoGrad,
                                                NvNovoGrad, RMSpropTF,
                                                create_optimizer)
from deepfake_detection_tpu_torch.train.state import create_train_state
from deepfake_detection_tpu_torch.train.steps import make_train_step
from test_torch_train import _Params, _close_change
from test_torch_train import _opt_cfg as _cfg

torch.set_num_threads(2)

_PSHAPES = {"conv": (3, 3, 2, 4), "dense": (5, 3), "bias": (3,)}
LRS = [0.1, 0.1, 0.05, 0.02, 0.02, 0.01, 0.01]
NAMES = ["sgd", "adam", "adamw", "nadam", "radam", "adadelta", "rmsprop",
         "rmsproptf", "novograd", "nvnovograd", "lamb"]
CLASSES = {"sgd": torch.optim.SGD, "adam": Adam, "adamw": Adam,
           "nadam": Adam, "radam": Adam, "adadelta": Adadelta,
           "rmsprop": RMSpropTF, "rmsproptf": RMSpropTF,
           "novograd": NovoGrad, "nvnovograd": NvNovoGrad, "lamb": Lamb}
ALIASES = {"fused": "sgd", "fusedsgd": "sgd", "fusedadam": "adam",
           "fusedadamw": "adamw", "fusedlamb": "lamb",
           "fusednovograd": "novograd", "lookahead_fusedadam": "adam"}


def _problem(seed, steps):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in _PSHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.5).astype(np.float32)
              for k, s in _PSHAPES.items()} for _ in range(steps)]
    return params, grads


def _run_both(opt, wd, steps, seed=0, lrs=LRS):
    """``steps`` updates of the JAX chain and of the port's optimizer on
    the same gradients, lr ``lrs[i]`` at step i; returns (initial, JAX
    params, port model)."""
    params, grads = _problem(seed, steps)
    tx = j_create_opt(_cfg(opt, wd), learning_rate=lrs[0])
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    model = _Params(params)
    topt = create_optimizer(_cfg(opt, wd), model, lrs[0])
    for g, lr in zip(grads, lrs[:steps]):
        st.hyperparams["learning_rate"] = jnp.asarray(lr)
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for group in topt.param_groups:
            group["lr"] = lr
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
    return params, jp, model


OPTS = [prefix + name for prefix in ("", "lookahead_")
        for name in NAMES + [a for a in ALIASES if "_" not in a]] + \
    [a for a in ALIASES if "_" in a]


@pytest.mark.parametrize("wd", [0.0, 1e-2])
@pytest.mark.parametrize("opt", OPTS)
def test_optimizer_matches_the_jax_factory(opt, wd):
    name = opt.split("_")[-1]
    steps = 7 if "lookahead_" in opt else 5
    if ALIASES.get(name, name) == "radam":
        steps = 5                   # the rectified branch: its own test
    params, jp, model = _run_both(opt, wd, steps)
    for k, p in model.named_parameters():
        _close_change(p.detach().numpy(), jp[k], params[k], f"{opt} {k}",
                      rel=1e-6, steps=steps)
        assert not np.array_equal(p.detach().numpy(), params[k]), k


def test_radam_rectified_branch_matches_within_the_pow_rounding():
    lrs = LRS + [0.01] * 6
    for wd in (0.0, 1e-2):
        _, jp5, _ = _run_both("radam", wd, 5, seed=1, lrs=lrs)
        _, jp13, m13 = _run_both("radam", wd, 13, seed=1, lrs=lrs)
        for k, p in m13.named_parameters():
            # the rectified steps 6..13 moved each leaf by want - jp5
            err = np.abs(p.detach().numpy() - np.asarray(jp13[k])).max()
            change = np.abs(np.asarray(jp13[k]) - np.asarray(jp5[k])).max()
            assert err <= 1e-2 * change + 26 * 1.2e-7 * np.abs(
                np.asarray(jp13[k])).max(), (k, err, change)
    # the port's r against float64 from the same f32 b2^t
    b2 = 0.999
    ro_inf = 2.0 / (1.0 - b2) - 1.0
    for t in range(5, 14):
        b2t = torch.pow(b2, torch.tensor(float(t)))
        ro = ro_inf - 2 * torch.tensor(float(t)) * b2t / (1 - b2t)
        r = torch.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                       / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
        b64 = float(b2t)
        ro64 = ro_inf - 2 * t * b64 / (1 - b64)
        r64 = math.sqrt((ro64 - 4) * (ro64 - 2) * ro_inf
                        / ((ro_inf - 4) * (ro_inf - 2) * ro64))
        assert abs(float(r) - r64) <= 1e-5 * r64, (t, float(r), r64)


@pytest.mark.parametrize("name", NAMES + ["lookahead_rmsproptf",
                                          "lookahead_adam"])
def test_factory_classes_groups_and_state_at_construction(name):
    params, _ = _problem(2, 1)
    model = _Params(params)
    lr, wd = 0.1, 1e-2
    opt = create_optimizer(_cfg(name, wd), model, lr)
    base = name.split("_")[-1]
    inner = opt.inner if isinstance(opt, Lookahead) else opt
    assert isinstance(opt, Lookahead) == name.startswith("lookahead_")
    assert type(inner) is CLASSES[base]
    # the decay mask: conv and dense decayed, the bias not; adamw and
    # radam carry wd / lr, as the JAX factory's compensation
    want = wd / lr if base in ("adamw", "radam") else wd
    decayed = {id(p) for g in opt.param_groups if g["weight_decay"]
               for p in g["params"]}
    assert decayed == {id(model.conv), id(model.dense)}
    assert {g["weight_decay"] for g in opt.param_groups} == {want, 0.0}
    assert opt.param_groups is inner.param_groups
    for p in model.parameters():
        st = opt.state[p]
        assert st and all(torch.is_tensor(v) for v in st.values()), st
        if isinstance(opt, Lookahead):
            assert torch.equal(st["lookahead_slow"], p.detach())


@pytest.mark.parametrize("name", NAMES + ["lookahead_rmsproptf",
                                          "lookahead_adam", "lookahead_sgd"])
def test_checkpoint_round_trip_continues_bitwise(name):
    """3 steps, ``state_dict`` through ``torch.save`` into a fresh model
    and optimizer, 4 more steps (a lookahead sync among them) in both:
    parameters and every state tensor bitwise equal."""
    params, grads = _problem(3, 7)

    def make():
        m = _Params(params)
        return m, create_optimizer(_cfg(name, 1e-2), m, 0.05)

    def step(m, o, g):
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        o.step()

    m1, o1 = make()
    for g in grads[:3]:
        step(m1, o1, g)
    buf = io.BytesIO()
    torch.save({"model": m1.state_dict(), "opt": o1.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    m2, o2 = make()
    m2.load_state_dict(saved["model"])
    o2.load_state_dict(saved["opt"])
    for g in grads[3:]:
        step(m1, o1, g)
        step(m2, o2, g)
    for (k, a), b in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(a, b), k
    if isinstance(o2, Lookahead):
        assert o2.inner.state is o2.state
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        s1, s2 = o1.state[p1], o2.state[p2]
        assert s1.keys() == s2.keys()
        for k in s1:
            assert torch.equal(s1[k], s2[k]), (name, k)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 2)
        self.bn = torch.nn.BatchNorm1d(2)

    def forward(self, x, generator=None):
        return self.bn(self.fc(x))


@pytest.mark.parametrize("name", NAMES + ["lookahead_rmsproptf",
                                          "lookahead_lamb"])
def test_nan_gradient_leaves_the_state_bitwise(name):
    """Two clean guarded steps, then a NaN batch: every tensor of the
    state (the optimizer's moments and counters included) unchanged."""
    torch.manual_seed(0)
    model = _Tiny()
    ts = create_train_state(model, create_optimizer(_cfg(name, 1e-2), model,
                                                    0.05), with_ema=True)
    step = make_train_step(t_losses.cross_entropy, clip_grad=1.0,
                           nonfinite_guard=True)
    x = torch.randn(6, 4)
    y = torch.tensor([0, 1, 1, 0, 1, 0])
    for _ in range(2):
        assert float(step(ts, x, y)["nonfinite"]) == 0.0
    before = [t.clone() for t in ts.tensors()]
    m = step(ts, torch.full_like(x, float("nan")), y)
    assert float(m["nonfinite"]) == 1.0
    after = ts.tensors()
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))
    # the optimizer's state is in the flat buffers the guard restores
    opt_tensors = [v for st in ts.optimizer.state.values()
                   for v in st.values()]
    flats = ts.flat_buffers()
    assert all(t.untyped_storage().data_ptr()
               == flats[t.dtype].untyped_storage().data_ptr()
               for t in opt_tensors)
