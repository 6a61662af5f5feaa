"""The port's blockwise 8-bit AdamW and remat policies against the JAX package.

``models/optim.py``: the same gradients through ``scale_by_adam8`` of both
packages for five steps, on leaves whose sizes are and are not multiples of
BLOCK, a scalar and a bf16 leaf: int8 payloads equal (any payload apart
is counted, at most one unit, and none is), scales and steps within 1e-6
relative; the whole ``adamw8bit`` chain with a schedule on
parameters; ``moment_bytes``; the counterpart of the JAX package's
``test_adamw8bit_tracks_adamw``; ``make_train_state(optimizer_name=
"adamw8bit")`` for three steps within ADAM_ATOL of JAX's; ``fit`` with
``TrainSpec(optimizer="adamw8bit")`` resuming bit for bit.  (The three
steps allow the few weights whose int8 moments the two packages round one
unit apart, from gradients that differ in summation order, more than
ADAM_ATOL; the test says how few and how far.)

Remat: under each selective policy the tiny model's loss and gradients are
bitwise equal to block remat's, and the attention forward (the op under
``ops/flash_attention.py``) runs once a layer and step in place of twice,
with attention dropout too.  The policies against JAX's are in
``tests/test_torch_train.py`` (``test_unported_remat_policies_raise``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import make_train_state as jmake_state
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu.models import optim as joptim
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import TrainSpec as TSpec
from flash_attention_dlrs_tpu_torch.models import (
    adamw8bit, fit, init_params_numpy, loss_fn, make_train_state, make_train_step,
    params_from_jax, params_to_numpy,
)
from flash_attention_dlrs_tpu_torch.models import optim as toptim
from flash_attention_dlrs_tpu_torch.runtime import data as tdata

ADAM_ATOL = 3e-5
STEP_RTOL = 1e-6

# leaves: a multiple of BLOCK, a ragged 2-D leaf, a scalar, and a bf16 leaf
LEAVES = (((512,), np.float32), ((37, 53), np.float32), ((), np.float32),
          ((16, 24), jnp.bfloat16))


def _grads(rng):
    return [rng.standard_normal(shape).astype(np.float32) for shape, _ in LEAVES]


def test_scale_by_adam8_matches_jax_over_five_steps():
    rng = np.random.default_rng(0)
    jt, tt = joptim.scale_by_adam8(), toptim.scale_by_adam8()
    params = [np.zeros(shape, np.float32) for shape, _ in LEAVES]
    jstate = jt.init([jnp.asarray(p, dtype) for p, (_, dtype) in zip(params, LEAVES)])
    tstate = tt.init([torch.zeros(shape) for shape, _ in LEAVES])
    ties = 0
    for _ in range(5):
        grads = _grads(rng)
        jg = [jnp.asarray(g).astype(dtype) for g, (_, dtype) in zip(grads, LEAVES)]
        tg = [torch.from_numpy(np.array(g.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
            for g, (_, dtype) in zip(jg, LEAVES)]
        jsteps, jstate = jt.update(jg, jstate)
        tsteps = tt.update(tg, tstate)
        for js, ts in zip(jsteps, tsteps):
            assert ts.dtype == (torch.bfloat16 if js.dtype == jnp.bfloat16 else torch.float32)
            np.testing.assert_allclose(ts.float().numpy(), np.asarray(js.astype(jnp.float32)),
                                       rtol=STEP_RTOL, atol=0)
        for q, scale in (("mu_q", "mu_scale"), ("su_q", "su_scale")):
            for jq, js, tq, ts in zip(getattr(jstate, q), getattr(jstate, scale),
                                      getattr(tstate, q), getattr(tstate, scale)):
                np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=STEP_RTOL, atol=0)
                jq, tq = np.asarray(jq).astype(np.int32), tq.numpy().astype(np.int32)
                off = jq != tq
                assert np.abs(jq - tq).max() <= 1
                ties += int(off.sum())
    assert tstate.count == int(jstate.count) == 5
    assert ties == 0, f"{ties} payloads one unit apart"


@pytest.mark.parametrize("schedule", [False, True])
def test_adamw8bit_chain_matches_jax(schedule):
    """Parameters through both packages' adamw8bit for five updates, with a
    constant learning rate and with optax's linear schedule."""
    rng = np.random.default_rng(1)
    lr = optax.linear_schedule(1e-2, 1e-3, 5) if schedule else 1e-2
    tlr = (lambda count: float(lr(count))) if schedule else lr
    init = [rng.standard_normal(shape).astype(np.float32) for shape, _ in LEAVES[:3]]
    jopt = joptim.adamw8bit(lr, weight_decay=0.1)
    jp = [jnp.asarray(a) for a in init]
    jstate = jopt.init(jp)
    module = torch.nn.Module()
    module.params = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(a.copy()))
                                           for a in init)
    topt = adamw8bit(tlr, weight_decay=0.1)
    tstate = topt.init(module)
    for _ in range(5):
        grads = [rng.standard_normal(a.shape).astype(np.float32) for a in init]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(module.params, grads):
            p.grad = torch.from_numpy(g)
        topt.update(module, tstate)
    for p, a in zip(module.params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a), rtol=STEP_RTOL,
                                   atol=1e-7)
    assert tstate.count == 5


@pytest.mark.parametrize("form", ["callable", "tree"])
def test_adamw8bit_mask_matches_jax(form):
    """adamw8bit's weight-decay ``mask`` (optax's add_decayed_weights mask
    over the JAX params layout): the tiny model's weights through both
    packages for three updates on the same gradients, decay on the matrices
    only (norms spared), the mask given as a callable and as a tree."""
    jcfg, tcfg = _configs(remat=False)
    tree = init_params_numpy(tcfg, 3)
    jp = jax.tree.map(jnp.asarray, tree)

    def matrices(params):
        return jax.tree.map(lambda x: x.ndim > 1, params)

    mask = matrices if form == "callable" else matrices(tree)
    assert not mask(tree)["final_norm"] if callable(mask) else not mask["final_norm"]
    jopt = joptim.adamw8bit(1e-2, weight_decay=0.5, mask=mask)
    jstate = jopt.init(jp)
    model = params_from_jax(tree, tcfg, device="cpu")
    topt = adamw8bit(1e-2, weight_decay=0.5, mask=mask)
    tstate = topt.init(model)
    assert toptim.decay_mask(model, mask).count(False) == 1 + 2 * tcfg.n_layers
    rng = np.random.default_rng(4)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        updates, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tgrads = params_from_jax(grads, tcfg, device="cpu")
        for p, g in zip(model.parameters(), tgrads.parameters()):
            p.grad = g.detach().clone()
        topt.update(model, tstate)
    got = params_to_numpy(model)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp), jax.tree.leaves(got)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=STEP_RTOL, atol=1e-7,
                                   err_msg=_jname(path))


def test_moment_bytes_match_jax():
    shapes = [shape for shape, _ in LEAVES] + [(256 * 3,), (1, 257)]
    want = joptim.moment_bytes([jnp.zeros(s) for s in shapes])
    assert toptim.moment_bytes([torch.zeros(s) for s in shapes]) == want
    module = torch.nn.Module()
    module.params = torch.nn.ParameterList(torch.nn.Parameter(torch.zeros(s)) for s in shapes)
    assert toptim.moment_bytes(module) == want


def test_adamw8bit_tracks_adamw():
    """The counterpart of the JAX package's test (tests/test_models.py):
    blockwise-int8 AdamW trains like exact AdamW on a least-squares problem,
    within 5% of its loss at every one of 20 steps, with int8 moments and
    under 55% of its moment bytes."""
    from flash_attention_dlrs_tpu_torch.models.train import AdamW

    rng = np.random.default_rng(0)
    w = {"a": rng.standard_normal((37, 53)).astype(np.float32),
         "b": rng.standard_normal((toptim.BLOCK * 3,)).astype(np.float32)}
    x = torch.from_numpy(rng.standard_normal((64, 37)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 53)).astype(np.float32))

    def run(optimizer, steps=20):
        module = torch.nn.Module()
        module.a = torch.nn.Parameter(torch.from_numpy(w["a"].copy()))
        module.b = torch.nn.Parameter(torch.from_numpy(w["b"].copy()))
        state = optimizer.init(module)
        hist = []
        for _ in range(steps):
            module.zero_grad()
            loss = torch.mean((x @ module.a - y) ** 2) + 1e-3 * torch.sum(module.b ** 2)
            loss.backward()
            optimizer.update(module, state)
            hist.append(loss.item())
        return hist, state, module

    h_exact, _, _ = run(AdamW(1e-2, weight_decay=0.01))
    h_q8, s_q8, module = run(adamw8bit(1e-2, weight_decay=0.01))
    assert h_q8[-1] < h_q8[0] * 0.7, h_q8
    for a, b in zip(h_exact, h_q8):
        assert abs(a - b) <= 0.05 * abs(a) + 1e-3, (a, b)
    assert s_q8.adam8.mu_q[0].dtype == s_q8.adam8.su_q[1].dtype == torch.int8
    full, q8 = toptim.moment_bytes(module)
    assert q8 < 0.55 * full


def _configs(**kw):
    return (JConfig.tiny(dtype=jnp.float32, **kw),
            TConfig.tiny(dtype=torch.float32, **kw))


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _jname(path):
    return ".".join(str(k.key) if hasattr(k, "key") else str(k.idx) for k in path)


def test_make_train_state_adamw8bit_three_steps_match_jax():
    """Losses within 1e-5 of JAX's and the weights within ADAM_ATOL, but for
    a few: the models' gradients differ in summation order (~1e-7), and 8-bit
    moments amplify that twice.  Where x / absmax · 127 sits that close to a
    half the packages round one unit apart (never when both get the same
    gradients: test_scale_by_adam8_matches_jax_over_five_steps), and a moment
    that quantizes to 0 in its block leaves the next step Adam's first-step
    sign of a near-zero gradient, a full lr either way.  So: payloads at most
    one unit apart on under 1% of the weights, at most 0.5% of the weights
    past ADAM_ATOL, none past 3 steps' length, 3 lr."""
    jcfg, tcfg = _configs(remat=False)
    jparams, jstate, jopt = jmake_state(jax.random.PRNGKey(0), jcfg,
                                        optimizer_name="adamw8bit")
    tree = jax.tree.map(np.asarray, jparams)
    step_j = jstep(jcfg, jopt)
    model, opt_state, optimizer = make_train_state(tcfg, params=tree, device="cpu",
                                                   optimizer_name="adamw8bit")
    assert opt_state.adamw is None and opt_state.adam8 is not None
    step_t = make_train_step(tcfg, optimizer)
    names = [n for n, _ in model.named_parameters()]
    total = sum(p.numel() for p in model.parameters())
    for i in range(3):
        toks = _tokens(10 + i)
        jparams, jstate, lj = step_j(jparams, jstate, jnp.asarray(toks))
        lt = step_t(model, opt_state, torch.from_numpy(toks))
        np.testing.assert_allclose(lt.item(), float(lj), atol=1e-5, rtol=0)
        for q in ("mu_q", "su_q"):
            want = {_jname(path): np.asarray(leaf) for path, leaf in
                    jax.tree_util.tree_flatten_with_path(getattr(jstate[0], q))[0]}
            apart = [np.abs(want[n].astype(np.int32) - got.numpy().astype(np.int32))
                     for n, got in zip(names, getattr(opt_state.adam8, q))]
            assert max(a.max() for a in apart) <= 1
            assert sum(int((a != 0).sum()) for a in apart) < 1e-2 * total
    want = {_jname(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    diff = np.concatenate([np.abs(p.detach().numpy() - want[n]).reshape(-1)
                           for n, p in model.named_parameters()])
    assert (diff > ADAM_ATOL).sum() < 5e-3 * total
    assert diff.max() <= 3 * 3e-4
    assert opt_state.count == 3


def test_fit_with_adamw8bit_resumes_bit_for_bit(tmp_path):
    _, tcfg = _configs(remat=True)
    rng = np.random.default_rng(1)
    toks = (np.arange(2000) * 7 % 23).astype(np.int32)
    noise = rng.random(2000) < 0.05
    toks[noise] = rng.integers(0, 256, noise.sum())
    ds = tdata.TokenDataset(toks, seq_len=32)
    spec = TSpec(learning_rate=2e-3, warmup_steps=2, total_steps=6, grad_clip_norm=1.0,
                 optimizer="adamw8bit")

    def stream(state):
        return tdata.batches(ds, batch_size=2, seed=3, state=state)

    kw = dict(spec=spec, seed=0, device="cpu")
    full = fit(tcfg, stream, steps=6, checkpoint_dir=str(tmp_path / "a"), **kw)
    fit(tcfg, stream, steps=3, checkpoint_dir=str(tmp_path / "b"), **kw)
    resumed = fit(tcfg, stream, steps=6, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed["opt_state"].count == full["opt_state"].count == 6
    for (name, a), b in zip(full["model"].named_parameters(), resumed["model"].parameters()):
        assert torch.equal(a, b), name
    for name in ("mu_q", "mu_scale", "su_q", "su_scale"):
        for a, b in zip(getattr(full["opt_state"].adam8, name),
                        getattr(resumed["opt_state"].adam8, name)):
            assert torch.equal(a, b), name


REMAT = ("save_flash", "save_dots", "save_matmuls")


@pytest.fixture(scope="module")
def tree():
    _, tcfg = _configs(remat=False)
    return init_params_numpy(tcfg, seed=0)


def _loss_grads_and_forwards(tree, cfg, seed=None):
    """loss_fn's value and gradients on tokens(1), and how many times the
    attention forward ran (the op ops/flash_attention.py calls)."""
    fa = importlib.import_module("flash_attention_dlrs_tpu_torch.ops.flash_attention")
    calls, real = [], fa.attn_fwd
    fa.attn_fwd = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        model = params_from_jax(tree, cfg, device="cpu")
        loss = loss_fn(model, torch.from_numpy(_tokens(1)), cfg, dropout_seed=seed)
        loss.backward()
    finally:
        fa.attn_fwd = real
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, len(calls)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
@pytest.mark.parametrize("policy", REMAT)
def test_remat_policy_equals_block_and_runs_the_forward_once(tree, policy, dropout):
    _, base = _configs(remat=True, attn_dropout=dropout)
    seed = 9 if dropout else None
    want_loss, want_grads, block_calls = _loss_grads_and_forwards(tree, base, seed)
    loss, grads, calls = _loss_grads_and_forwards(
        tree, dataclasses.replace(base, remat_policy=policy), seed)
    assert block_calls == 2 * base.n_layers  # forward, then the backward's recompute
    assert calls == base.n_layers
    assert torch.equal(loss, want_loss)
    assert all(torch.equal(grads[n], want_grads[n]) for n in want_grads)
