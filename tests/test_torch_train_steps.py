"""Three optimizer steps of the port's ``make_train_step`` against the JAX
package's jitted ``make_train_step``, from the same params and batch, at
f32 with dropout 0, for every optimizer setting that changes the update:
Adam with clipping that triggers, SGD with momentum, weight decay and the
L2 term, Adamax, warmup into a staircase decay, and ``fix_embeddings``.
Then the learning-rate schedule against optax's own.

Tolerances: loss and grad norm 1e-5 relative; parameters 2e-5 abs after
three steps at lr 1e-3.  An Adam-family step is lr * m / (sqrt(v) + eps):
it scales a gradient entry to about lr whatever its size, so an entry that
is rounding noise in both frameworks moves by +-lr in each.  The ranking
MLP's output bias is such an entry -- the listwise softmax loss does not
change when every score shifts by one constant, so its gradient is 0 up to
rounding -- and it is compared under SGD only.  The optimizer itself is
held to optax on identical gradients (near-zero entries included) to
two float32 ulps.
"""

import jax
import numpy as np
import optax
import pytest
import torch
from test_torch_cars import port_batch, port_model, tiny_setup

from context_attentive_ir_tpu.models import build_model
from context_attentive_ir_tpu.train.state import TrainState as JaxTrainState
from context_attentive_ir_tpu.train.state import (
    make_optimizer as jax_make_optimizer,
)
from context_attentive_ir_tpu.train.steps import (
    make_train_step as jax_make_train_step,
)
from context_attentive_ir_tpu_torch.config import ModelConfig as PortConfig
from context_attentive_ir_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from context_attentive_ir_tpu_torch.train.state import (
    make_optimizer,
    make_schedule,
)

STEPS = 3
REL = 1e-5
PARAM_TOL = 2e-5
NOISE_ONLY = "rank_mlp.fc1.bias"   # gradient 0 up to rounding (listwise)

CONFIGS = {
    "adam_clipped": dict(optimizer="adam", learning_rate=1e-3,
                         grad_clipping=0.05),
    "sgd_momentum_decay_l2": dict(optimizer="sgd", learning_rate=0.5,
                                  momentum=0.9, weight_decay=0.01,
                                  regularize_coeff=1e-3),
    "adamax": dict(optimizer="adamax", learning_rate=1e-3),
    "warmup_then_decay": dict(optimizer="adam", learning_rate=1e-3,
                              warmup_steps=1, lr_decay_steps=1,
                              lr_decay=0.5),
    "fix_embeddings": dict(optimizer="adam", learning_rate=1e-3,
                           fix_embeddings=True),
}


@pytest.fixture(scope="module")
def setup():
    return tiny_setup()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_steps_match_jax(setup, name):
    _, cfg, params, batch, _, _ = setup
    cfg = cfg.replace(**CONFIGS[name])
    jm = build_model(cfg)
    jstate = JaxTrainState.create(apply_fn=jm.apply, params=params,
                                  tx=jax_make_optimizer(cfg))
    jstep = jax_make_train_step(jm, cfg)
    pcfg = PortConfig.from_json(cfg.to_json())
    pm = port_model(cfg, params)
    pstate = create_train_state(pm, pcfg)
    pstep = make_train_step(pm, pcfg)
    pb = port_batch(batch)
    start = {n: p.detach().clone() for n, p in pm.named_parameters()}

    for i in range(STEPS):
        jstate, mj = jstep(jstate, batch, jax.random.key(1))
        pstate, mp = pstep(pstate, pb, 1)
        for k in ("loss", "rank_loss", "gen_loss", "grad_norm"):
            assert _rel(mp[k], mj[k]) <= REL, (i, k, float(mp[k]),
                                               float(mj[k]))
        if name == "adam_clipped":
            assert float(mp["grad_norm"]) > cfg.grad_clipping
        if name == "warmup_then_decay" and i == 0:
            # the first update runs at learning rate 0
            assert all(torch.equal(p, start[n])
                       for n, p in pm.named_parameters())
    assert pstate.step == STEPS and pstate.opt_state["count"] == STEPS

    flat_j = _flat(jax.device_get(jstate.params))
    for n, p in pm.named_parameters():
        err = float(np.max(np.abs(p.detach().numpy() - flat_j[n])))
        if n == NOISE_ONLY and CONFIGS[name]["optimizer"] != "sgd":
            continue
        assert err <= PARAM_TOL, (n, err)
    moved = sum(not torch.equal(p, start[n])
                for n, p in pm.named_parameters())
    assert moved > 0
    table = "embeddings.embedding"
    if name == "fix_embeddings":
        assert torch.equal(pm.embeddings.embedding, start[table])
        assert table not in pstate.opt_state["mu"]
        assert table not in pstate.opt_state["nu"]
    else:
        assert not torch.equal(pm.embeddings.embedding, start[table])


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1),
    dict(learning_rate=0.1, warmup_steps=3),
    dict(learning_rate=0.1, lr_decay_steps=2, lr_decay=0.5),
    dict(learning_rate=0.1, warmup_steps=2, lr_decay_steps=3, lr_decay=0.7),
])
def test_schedule_matches_optax(kw):
    """The port's schedule against the optax schedule the JAX package's
    ``make_optimizer`` builds, over the first 12 update counts."""
    cfg = PortConfig(**kw)
    lr = cfg.learning_rate
    ref = lr
    if cfg.lr_decay_steps > 0 and cfg.lr_decay < 1.0:
        ref = optax.exponential_decay(lr, cfg.lr_decay_steps, cfg.lr_decay,
                                      staircase=True)
    if cfg.warmup_steps > 0:
        base = ref if callable(ref) else optax.constant_schedule(ref)
        ref = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, cfg.warmup_steps), base],
            [cfg.warmup_steps])
    sched = make_schedule(cfg)
    for count in range(12):
        want = float(ref(count)) if callable(ref) else ref
        assert abs(sched(count) - want) <= 1e-7 * lr, (count, sched(count),
                                                      want)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_optimizer_matches_optax_on_equal_grads(name):
    """The port's optimizer and the JAX package's optax chain, fed the same
    parameters and three gradients (with exact zeros and entries near eps),
    make the same updates; the frozen table keeps no state."""
    kw = {k: v for k, v in CONFIGS[name].items() if k != "regularize_coeff"}
    cfg = PortConfig(**kw)
    rng = np.random.RandomState(0)
    shapes = {"embeddings": {"embedding": (7, 3)},
              "dense": {"kernel": (3, 4), "bias": (4,)}}
    params = {m: {k: rng.normal(size=s).astype(np.float32)
                  for k, s in leaves.items()} for m, leaves in shapes.items()}
    grads = []
    for _ in range(STEPS):
        g = {m: {k: (rng.normal(size=s) * 0.1).astype(np.float32)
                 for k, s in leaves.items()} for m, leaves in shapes.items()}
        g["dense"]["bias"][:2] = [0.0, 3e-9]
        grads.append(g)

    from context_attentive_ir_tpu.config import ModelConfig as JaxConfig

    tx = jax_make_optimizer(JaxConfig.from_json(cfg.to_json()))
    jp = jax.tree_util.tree_map(np.asarray, params)
    opt = tx.init(jp)
    port = make_optimizer(cfg)
    pp = {f"{m}.{k}": torch.from_numpy(v.copy())
          for m, leaves in params.items() for k, v in leaves.items()}
    state = port.init(pp)
    for g in grads:
        upd, opt = tx.update(g, opt, jp)
        jp = optax.apply_updates(jp, upd)
        norm = port.apply(pp, {f"{m}.{k}": torch.from_numpy(v)
                               for m, leaves in g.items()
                               for k, v in leaves.items()}, state)
        assert _rel(norm, optax.global_norm(g)) <= 1e-6
    for m, leaves in jp.items():
        for k, v in leaves.items():
            err = float(np.max(np.abs(pp[f"{m}.{k}"].numpy() - v)))
            assert err <= 2.5e-7, (m, k, err)  # two f32 ulps at |p| < 2
    frozen = "embeddings.embedding"
    if cfg.fix_embeddings:
        assert torch.equal(pp[frozen], torch.from_numpy(
            params["embeddings"]["embedding"]))
        assert all(frozen not in v for v in state.values()
                   if isinstance(v, dict))
