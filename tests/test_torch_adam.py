"""grandtpu_torch.train.adam against grandtpu's optimizer: optax's chain of
``grandtpu/train/step.py:45`` ``make_optimizer``, updated and applied in
one jitted function on the CPU as grandtpu's steps run it. Both take the
same seeded numpy parameters and 20 steps of seeded numpy gradients, on the
dense MLP's leaves (with and without BatchNorm: without it the BN
parameters get no gradient) and on the MAG engine's table and head, with
weight decay 0 and 1e-3.

Tolerance: every leaf's value, mu and nu after every step within
max |port - jax| / max |jax| <= 1e-6 (about 8 ulps of the leaf's largest
element); the step count equal. The port rounds every operation (the
kernel's plain version); XLA's CPU program does not: LLVM contracts the
moment updates, the weight decay and the parameter update into fused
multiply-adds (which product it fuses depends on the chain: measured
against a numpy emulation of each form), and XLA's simplifier computes
(mu / bc1) / (sqrt(nu / bc2) + eps) as mu / (bc1 * (sqrt(nu / bc2) +
eps)). The largest difference measured over these 20 steps is 3.6e-7 of
a leaf's largest element (the dense MLP, wd 1e-3; 2.1e-7 without weight
decay), about 3 ulps of it; most of it is the moments' rounding where
(1 - b1) g and b1 mu nearly cancel. Where no fused
multiply-add can differ, the leaves are bit for bit: mu and nu after the
first step without weight decay (the moments start at zero), and the
count always.
"""

import copy

import jax
import numpy as np
import optax
import pytest
import torch

from grandtpu.train import checkpoint as jckpt
from grandtpu.train import step as jstep

from grandtpu_torch.convert import mag_to_jax, mlp_to_jax
from grandtpu_torch.nn.mag_mlp import MagMLP
from grandtpu_torch.nn.mlp import MLP, MLPConfig
from grandtpu_torch.train import checkpoint as tckpt
from grandtpu_torch.train.adam import Adam, adam_update, adam_update_plain
from grandtpu_torch.train.step import make_optimizer

TOL = 1e-6
STEPS = 20
LR = 1e-2
ENGINES = {
    # the dense MLP: F 40, hidden 32, 3 layers (two BatchNorms)
    "dense_bn": (MLP, MLPConfig(num_features=40, num_classes=5, hidden=32,
                                nlayers=3, use_bn=True)),
    "dense": (MLP, MLPConfig(num_features=40, num_classes=5, hidden=32,
                             nlayers=3, use_bn=False)),
    # the MAG engine: a 600-word table at H 16 and its head (BN off, as
    # the mag_scholar_c preset)
    "mag": (MagMLP, MLPConfig(num_features=600, num_classes=5, hidden=16,
                              nlayers=2, use_bn=False)),
}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30)


def _model(engine: str, seed: int = 0):
    """The engine's model with seeded numpy parameters."""
    cls, cfg = ENGINES[engine]
    model = cls(cfg)
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.as_tensor(
                (0.5 * rs.randn(*p.shape)).astype(np.float32)))
    return model


def _to_jax(model):
    """grandtpu's params tree of ``model``, copied (on the CPU the arrays
    would share the parameters' memory, which the port's steps update)."""
    params = (mag_to_jax if isinstance(model, MagMLP) else mlp_to_jax)(
        model)[0]
    return jax.tree.map(np.copy, params)


def _gradients(model, seed: int = 1) -> list:
    """STEPS lists of seeded gradients, one a parameter (None for the BN
    parameters of a model without BatchNorm, which get none in training),
    each step's scale drawn over three decades."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        grads = []
        for name, p in model.named_parameters():
            g = (rs.randn(*p.shape) * 10.0 ** rs.uniform(-3, 0)).astype(
                np.float32)
            grads.append(None if name.startswith("bns.")
                         and not model.cfg.use_bn else g)
        out.append(grads)
    return out


def _grad_tree(model, grads):
    """grandtpu's gradient tree: a missing gradient is zeros, as
    jax.grad gives an unused parameter."""
    gm = copy.deepcopy(model)
    with torch.no_grad():
        for p, g in zip(gm.parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else torch.as_tensor(g))
    return _to_jax(gm)


def _port_step(model, opt, grads) -> None:
    for p, g in zip(model.parameters(), grads):
        p.grad = None if g is None else torch.as_tensor(g)
    opt.step()


def _jax_update(wd: float):
    optimizer = jstep.make_optimizer(LR, wd)

    @jax.jit
    def update(params, opt_state, grads):
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    return optimizer, update


def _flat_jax(tree) -> dict:
    return jckpt._flatten_with_paths(tree)[0]


def _check_against_optax(model, opt, wd, params, opt_state, step) -> float:
    """Every parameter, mu and nu of the port within TOL of grandtpu's, the
    count equal, the opt trees' paths the same; returns the largest
    difference."""
    got_p, _, got_o = tckpt.training_trees(model, opt, wd)
    got = {**{f"params|{k}": v for k, v in
              tckpt._flatten_with_paths(got_p).items()},
           **{f"opt|{k}": v for k, v in
              tckpt._flatten_with_paths(got_o).items()}}
    want = {**{f"params|{k}": v for k, v in _flat_jax(params).items()},
            **{f"opt|{k}": v for k, v in _flat_jax(opt_state).items()}}
    assert got.keys() == want.keys()
    worst = 0.0
    for key, w in want.items():
        if key.endswith(".count"):
            assert got[key].dtype == np.int32 and int(got[key]) == int(w) \
                == step, key
            continue
        err = rel(got[key], w)
        assert err <= TOL, (step, key, err)
        worst = max(worst, err)
    return worst


@pytest.mark.parametrize("wd", [0.0, 1e-3])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_adam_matches_optax_every_step(engine, wd):
    """20 steps: after each, every parameter, mu and nu within 1e-6 of
    optax's and the count equal, in the opt tree ``training_trees`` writes
    (grandtpu's paths). A parameter with no gradient moves as optax moves
    it: with weight decay, by the decay alone, and not at all without."""
    model = _model(engine)
    opt = make_optimizer(model, LR, wd)
    assert isinstance(opt, Adam) and opt.count.dtype == torch.int32
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer, update = _jax_update(wd)
    params = _to_jax(model)
    opt_state = optimizer.init(params)
    worst = 0.0
    for step, grads in enumerate(_gradients(model), 1):
        _port_step(model, opt, grads)
        params, opt_state = update(params, opt_state,
                                   _grad_tree(model, grads))
        worst = max(worst, _check_against_optax(model, opt, wd, params,
                                                opt_state, step))
    if not model.cfg.use_bn:
        for name, p in model.named_parameters():
            if name.startswith("bns."):
                assert torch.equal(p.detach(), start[name]) == (wd == 0), name
    print(f"{engine} wd {wd}: largest difference {worst:.3g} of a leaf's "
          f"largest element")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_first_step_moments_bit_for_bit(engine):
    """Without weight decay, from zero moments, the first step's mu and nu
    are optax's bit for bit: no fused multiply-add of XLA's can round
    them otherwise."""
    model = _model(engine)
    opt = make_optimizer(model, LR, 0.0)
    optimizer, update = _jax_update(0.0)
    params = _to_jax(model)
    grads = _gradients(model)[0]
    _port_step(model, opt, grads)
    _, opt_state = update(params, optimizer.init(params),
                          _grad_tree(model, grads))
    _, _, got_o = tckpt.training_trees(model, opt, 0.0)
    got = tckpt._flatten_with_paths(got_o)
    for key, w in _flat_jax(opt_state).items():
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)


@pytest.mark.parametrize("wd", [0.0, 1e-3])
@pytest.mark.parametrize("engine", ["dense", "mag"])
def test_restore_at_step_7_continues_bit_for_bit(tmp_path, engine, wd):
    """training_trees at step 7, written to latest.npz and restored into a
    fresh model and optimizer (restore_training makes its moments), then
    steps 8 to 20: bit for bit the uninterrupted run (parameters, mu, nu,
    count)."""
    model, grads = _model(engine), None
    opt = make_optimizer(model, LR, wd)
    grads = _gradients(model)
    for g in grads[:7]:
        _port_step(model, opt, g)
    params, state, ost = tckpt.training_trees(model, opt, wd)
    path = str(tmp_path / "latest.npz")
    tckpt.save_checkpoint(path, params=params, state=state, opt_state=ost,
                          num_batch=7)
    for g in grads[7:]:
        _port_step(model, opt, g)

    model2 = _model(engine, seed=5)
    opt2 = make_optimizer(model2, LR, wd)
    assert not opt2.state and int(opt2.count) == 0
    params_t, state_t = tckpt.training_templates(model2)
    lp, ls, lo, _ = tckpt.load_checkpoint(
        path, params_template=params_t, state_template=state_t,
        opt_template=tckpt.adam_tree(params_t, weight_decay=wd))
    tckpt.restore_training(model2, opt2, lp, ls, lo)
    assert int(opt2.count) == 7
    for g in grads[7:]:
        _port_step(model2, opt2, g)
    assert int(opt2.count) == int(opt.count) == STEPS
    for p, p2 in zip(model.parameters(), model2.parameters()):
        assert torch.equal(p, p2)
        for key in ("mu", "nu"):
            assert torch.equal(opt.state[p][key], opt2.state[p2][key]), key


def test_restore_copies_into_the_existing_state():
    """A restore into an optimizer that has stepped copies into its
    moments and count: the same tensors, new values."""
    model = _model("dense_bn")
    opt = make_optimizer(model, LR, 1e-3)
    grads = _gradients(model)
    for g in grads[:3]:
        _port_step(model, opt, g)
    params, state, ost = tckpt.training_trees(model, opt, 1e-3)
    for g in grads[3:5]:
        _port_step(model, opt, g)
    held = [(opt.state[p]["mu"], opt.state[p]["nu"])
            for p in model.parameters()]
    count = opt.count
    tckpt.restore_training(model, opt, params, state, ost)
    assert opt.count is count and int(count) == 3
    for p, (mu, nu) in zip(model.parameters(), held):
        assert opt.state[p]["mu"] is mu and opt.state[p]["nu"] is nu
    _, _, again = tckpt.training_trees(model, opt, 1e-3)
    for key, w in tckpt._flatten_with_paths(ost).items():
        np.testing.assert_array_equal(
            tckpt._flatten_with_paths(again)[key], w, err_msg=key)


@pytest.mark.parametrize("wd", [0.0, 1e-3])
def test_adam_update_on_the_cpu_is_the_plain_version(monkeypatch, wd):
    """adam_update on CPU tensors runs adam_update_plain (the kernel
    library is never loaded) and counts no launch; a null gradient is a
    zero one."""
    from grandtpu_torch.train import adam as tadam

    def no_library():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tadam, "load_kernels", no_library)
    rs = np.random.RandomState(3)
    shapes = [(7, 5), (33,), (4,)]
    leaves = [torch.as_tensor(rs.randn(*s).astype(np.float32))
              for s in shapes]
    grads = [torch.as_tensor(rs.randn(*s).astype(np.float32))
             for s in shapes[:2]] + [None]
    mus = [torch.as_tensor(rs.randn(*s).astype(np.float32)) for s in shapes]
    nus = [torch.as_tensor(rs.rand(*s).astype(np.float32)) for s in shapes]
    bc = torch.tensor([0.271, 0.00299], dtype=torch.float32)
    copies = [[t.clone() for t in ts] for ts in (leaves, mus, nus)]
    before = adam_update.launches
    adam_update(leaves, grads, mus, nus, bc[0], bc[1], LR, wd)
    assert adam_update.launches == before
    grads_0 = grads[:2] + [torch.zeros(4)]
    adam_update_plain(*copies[:1], grads_0, *copies[1:], bc[0], bc[1], LR,
                      wd)
    for got, want in zip(leaves + mus + nus, sum(copies, [])):
        assert torch.equal(got, want)
