"""The PyTorch port's training path against the JAX package's.

The JAX params of ``ModelConfig.tiny(dtype=float32)`` go across with
``params_from_jax``; the same seeded tokens then go through ``loss_fn``,
its gradients, the train step, the schedules, clipping, accumulation and the
loader of both packages.  fp32 throughout; the paths differ only in
summation order (attention: the kernels' plain version against the JAX
Pallas routes in interpret mode), so losses and gradients agree to 1e-5.
Trained weights agree to ADAM_ATOL: AdamW's early updates are
lr·g/(|g| + eps) per element, so a weight whose gradient sits at the
summation-order noise (~3e-7 here) moves by a different fraction of
lr = 3e-4 in the two packages; 3e-5 is a tenth of one step's movement.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import TrainSpec as JSpec
from flash_attention_dlrs_tpu.models import init_params, loss_fn as jloss
from flash_attention_dlrs_tpu.models import lr_schedule as jschedule
from flash_attention_dlrs_tpu.models import make_accum_train_step as jaccum
from flash_attention_dlrs_tpu.models import make_train_state as jmake_train_state
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu.runtime import data as jdata
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import TrainSpec as TSpec
from flash_attention_dlrs_tpu_torch.models import (
    fit, loss_fn as tloss, lr_schedule as tschedule, make_accum_train_step,
    make_optimizer, make_train_state, make_train_step, params_from_jax,
    params_to_numpy,
)
from flash_attention_dlrs_tpu_torch.models.train import AdamW, clip_by_global_norm
from flash_attention_dlrs_tpu_torch.runtime import data as tdata
from flash_attention_dlrs_tpu_torch.utils import checkpoint as tckpt
from flash_attention_dlrs_tpu_torch.utils.metrics import MetricsLogger

ATOL = 1e-5
ADAM_ATOL = 3e-5


def _configs(**kw):
    return (JConfig.tiny(dtype=jnp.float32, **kw),
            TConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def tree():
    jcfg, _ = _configs(remat=False)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))


def _tokens(seed, b=2, n=33):
    return np.random.default_rng(seed).integers(0, 256, (b, n)).astype(np.int32)


def _assert_trees_close(got, want, atol=ATOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=1e-5)


def _grads(model):
    return params_to_numpy({n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("remat,chunk", [(False, 0), (True, 0), (True, 16)])
def test_loss_and_grads_match_jax(tree, remat, chunk):
    jcfg, tcfg = _configs(remat=remat, loss_chunk=chunk)
    toks = _tokens(0)
    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(toks), jcfg)
    model = params_from_jax(tree, tcfg, device="cpu")
    lt = tloss(model, torch.from_numpy(toks), tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=0)
    _assert_trees_close(_grads(model), gj)


def test_remat_recomputes_the_attention_forward(tree):
    from flash_attention_dlrs_tpu_torch.models import transformer

    calls = []
    real = transformer.flash_attention

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    for remat, expected in ((False, 2), (True, 4)):
        _, tcfg = _configs(remat=remat)
        model = params_from_jax(tree, tcfg, device="cpu")
        calls.clear()
        transformer.flash_attention = counting
        try:
            tloss(model, torch.from_numpy(_tokens(1)), tcfg).backward()
        finally:
            transformer.flash_attention = real
        assert len(calls) == expected  # 2 layers, once more each under remat


def test_three_train_steps_match_jax(tree):
    jcfg, tcfg = _configs(remat=False)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt = optax.adamw(3e-4, weight_decay=0.01)
    jstate, step_j = opt.init(jparams), jstep(jcfg, opt)
    model, opt_state, optimizer = make_train_state(tcfg, params=tree, device="cpu")
    step_t = make_train_step(tcfg, optimizer)
    for i in range(3):
        toks = _tokens(10 + i)
        jparams, jstate, lj = step_j(jparams, jstate, jnp.asarray(toks))
        lt = step_t(model, opt_state, torch.from_numpy(toks))
        np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=0)
    _assert_trees_close(params_to_numpy(model), jparams, atol=ADAM_ATOL)
    assert opt_state.count == 3


SPECS = {
    "constant": dict(learning_rate=1e-3),
    "warmup_constant": dict(learning_rate=1e-3, warmup_steps=10),
    "warmup_cosine": dict(learning_rate=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1),
    "cosine": dict(learning_rate=2e-3, total_steps=90, min_lr_ratio=0.05),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_lr_schedule_matches_optax(name):
    sj, st = jschedule(JSpec(**SPECS[name])), tschedule(TSpec(**SPECS[name]))
    want = np.asarray([float(sj(jnp.int32(c))) for c in range(121)])
    got = np.asarray([st(c) for c in range(121)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_is_optax_rule(max_norm):
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s, dtype=np.float32) for s in ((4, 5), (7,), (3, 3))]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(got, max_norm)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)),
                               rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    if max_norm > norm.item():
        assert all(np.array_equal(a.numpy(), g) for a, g in zip(got, grads))


def test_adamw_matches_optax_with_schedule_and_clip():
    """Raw parameters and gradients through both optimizers for four
    updates: warmup, cosine decay, weight decay on every leaf, clipping."""
    spec = dict(learning_rate=1e-2, warmup_steps=2, total_steps=6,
                weight_decay=0.1, grad_clip_norm=1.0)
    rng = np.random.default_rng(4)
    shapes = ((6, 3), (3,), (2, 2, 2))
    init = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    from flash_attention_dlrs_tpu.models import make_optimizer as jmake

    jopt = jmake(JSpec(**spec))
    jp = [jnp.asarray(a) for a in init]
    jstate = jopt.init(jp)
    module = torch.nn.Module()
    module.params = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(a.copy()))
                                           for a in init)
    topt = make_optimizer(TSpec(**spec))
    tstate = topt.init(module)
    for _ in range(4):
        grads = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
        updates, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(module.params, grads):
            p.grad = torch.from_numpy(g)
        topt.update(module, tstate)
    for p, a in zip(module.params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)


def test_adamw_keeps_moments_in_the_parameter_dtype():
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    module = torch.nn.Module()
    module.w = p
    opt = AdamW(1e-3)
    state = opt.init(module)
    p.grad = torch.full_like(p, 0.5)
    opt.update(module, state)
    moments = state.adamw.state[p]
    assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.bfloat16


def test_accumulation_equals_one_step(tree):
    jcfg, tcfg = _configs(remat=False)
    toks = _tokens(20, b=4)
    m1, s1, opt = make_train_state(tcfg, params=tree, device="cpu")
    l1 = make_train_step(tcfg, opt)(m1, s1, torch.from_numpy(toks))
    m2, s2, opt = make_train_state(tcfg, params=tree, device="cpu")
    l2 = make_accum_train_step(tcfg, opt, accum_steps=2)(m2, s2, torch.from_numpy(toks))
    np.testing.assert_allclose(l2.item(), l1.item(), atol=1e-6, rtol=0)
    # the step leaves the gradient it applied in .grad: the microbatch
    # mean must be the full batch's gradient
    _assert_trees_close(_grads(m2), _grads(m1), atol=1e-6)
    _assert_trees_close(params_to_numpy(m2), params_to_numpy(m1), atol=ADAM_ATOL)
    jopt = optax.adamw(3e-4, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams, _, lj = jaccum(jcfg, jopt, accum_steps=2)(
        jparams, jopt.init(jparams), jnp.asarray(toks))
    np.testing.assert_allclose(l2.item(), float(lj), atol=ATOL, rtol=0)
    _assert_trees_close(params_to_numpy(m2), jparams, atol=ADAM_ATOL)


def _dataset(seed=0, n_tokens=2000):
    # a learnable stream: a repeating pattern with a little noise
    rng = np.random.default_rng(seed)
    toks = (np.arange(n_tokens) * 7 % 23).astype(np.int32)
    noise = rng.random(n_tokens) < 0.05
    toks[noise] = rng.integers(0, 256, noise.sum())
    return tdata.TokenDataset(toks, seq_len=32)


def test_fit_learns_and_logs(tmp_path):
    _, tcfg = _configs(remat=False)
    ds = _dataset()
    losses = []
    log = tmp_path / "metrics.jsonl"
    fit(tcfg, tdata.batches(ds, batch_size=4, seed=1),
        spec=TSpec(learning_rate=3e-3, warmup_steps=2), steps=12, seed=0,
        device="cpu", metrics_path=str(log), log_every=4,
        on_step=lambda step, loss: losses.append(loss.item()))
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0]
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in recs] == [0, 4, 8, 11]
    assert all(r["loss"] > 0 and r["tokens_per_s"] >= 0 for r in recs)


def test_fit_resumes_bit_for_bit(tmp_path):
    _, tcfg = _configs(remat=True)
    ds = _dataset(1)
    spec = TSpec(learning_rate=2e-3, warmup_steps=2, total_steps=6, grad_clip_norm=1.0)

    def stream(state):
        return tdata.batches(ds, batch_size=2, seed=3, state=state)

    kw = dict(spec=spec, seed=0, device="cpu")
    full = fit(tcfg, stream, steps=6, checkpoint_dir=str(tmp_path / "a"), **kw)
    fit(tcfg, stream, steps=3, checkpoint_dir=str(tmp_path / "b"), **kw)
    resumed = fit(tcfg, stream, steps=6, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed["loader_state"] == full["loader_state"]
    assert resumed["opt_state"].count == full["opt_state"].count == 6
    for (name, a), b in zip(full["model"].named_parameters(),
                            resumed["model"].parameters()):
        assert torch.equal(a, b), name
    assert tckpt.latest_step(str(tmp_path / "b")) == 6


def test_batches_match_jax_loader():
    toks = np.random.default_rng(5).integers(0, 1000, 5000).astype(np.int32)
    jds, tds = jdata.TokenDataset(toks, 64), tdata.TokenDataset(toks, 64)
    jit_ = jdata.batches(jds, batch_size=8, seed=7, process_index=0, process_count=1)
    tit = tdata.batches(tds, batch_size=8, seed=7)
    for _ in range(20):  # crosses an epoch boundary (77 windows, 9 batches)
        (bj, sj), (bt, st) = next(jit_), next(tit)
        assert np.array_equal(bt, bj) and bt.dtype == bj.dtype
        assert (st.epoch, st.index) == (sj.epoch, sj.index)
    resumed = tdata.batches(tds, batch_size=8, seed=7, state=tdata.LoaderState(2, 16))
    assert np.array_equal(next(resumed)[0], next(jit_)[0])


def test_checkpoint_keeps_the_newest_three(tmp_path):
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(str(tmp_path), {"step": step, "w": torch.arange(step)},
                              step=step)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000003", "step_00000004", "step_00000005"]
    state, step = tckpt.restore_checkpoint(str(tmp_path))
    assert step == 5 and torch.equal(state["w"], torch.arange(5))
    assert tckpt.restore_checkpoint(str(tmp_path), step=3)[0]["step"] == 3
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"))


def test_metrics_logger_writes_jsonl(tmp_path):
    path = tmp_path / "sub" / "m.jsonl"
    logger = MetricsLogger(str(path))
    logger.log(3, loss=1.5)
    logger.close()
    rec = json.loads(path.read_text())
    assert rec["step"] == 3 and rec["loss"] == 1.5
    MetricsLogger(None).log(1, loss=0.0)  # no path: a no-op


def test_params_to_numpy_inverts_params_from_jax(tree):
    _, tcfg = _configs(remat=False)
    back = params_to_numpy(params_from_jax(tree, tcfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(back), jax.tree.leaves(tree)))


@pytest.mark.parametrize("policy", ["save_flash", "save_dots", "save_matmuls"])
def test_unported_remat_policies_raise(tree, policy):
    """The selective remat policies, ported: the JAX package refuses no use
    of them, so each case holds the port's loss and gradients under the
    policy against JAX's under the same policy (1e-5), and shows that a
    policy name neither package knows is block remat in both."""
    jcfg, tcfg = _configs(remat=True, remat_policy=policy)
    toks = _tokens(0)
    lj, gj = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                                       jcfg)
    model = params_from_jax(tree, tcfg, device="cpu")
    lt = tloss(model, torch.from_numpy(toks), tcfg)
    lt.backward()
    np.testing.assert_allclose(lt.item(), float(lj), atol=ATOL, rtol=0)
    _assert_trees_close(_grads(model), gj)
    _, unknown = _configs(remat=True, remat_policy=policy + "_unknown")
    _, block = _configs(remat=True)
    assert torch.equal(tloss(model, torch.from_numpy(toks), unknown),
                       tloss(model, torch.from_numpy(toks), block))


def _adamw8bit_state(cfg):
    """make_train_state's adamw8bit builds, and an unknown name is refused
    by both packages (the JAX package's only refusal of the option)."""
    from flash_attention_dlrs_tpu.models import make_train_state as jmake_state

    model, state, optimizer = make_train_state(cfg, optimizer_name="adamw8bit", device="cpu")
    assert state.adam8 is not None and state.adam8.count == 0
    assert type(optimizer).__name__ == "AdamW8bit"
    jcfg, _ = _configs(remat=False)
    with pytest.raises(ValueError, match="unknown optimizer"):
        jmake_state(jax.random.PRNGKey(0), jcfg, optimizer_name="adamw9bit")
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_train_state(cfg, optimizer_name="adamw9bit", device="cpu")


def _adamw8bit_spec(cfg):
    """make_optimizer of TrainSpec(optimizer="adamw8bit") builds, and an
    unknown TrainSpec optimizer is refused by both packages."""
    opt = make_optimizer(TSpec(optimizer="adamw8bit", grad_clip_norm=1.0))
    assert type(opt).__name__ == "AdamW8bit" and opt.grad_clip_norm == 1.0
    with pytest.raises(ValueError, match="unknown optimizer"):
        JSpec(optimizer="sgd")
    with pytest.raises(ValueError, match="unknown optimizer"):
        TSpec(optimizer="sgd")


def _misused_mesh(tcall, jcall):
    """A mesh whose model axis (3) divides neither head count of the tiny
    model (4 q, 2 kv): both packages refuse it with the same ValueError."""
    from jax.sharding import Mesh as JMesh

    from flash_attention_dlrs_tpu_torch.parallel.mesh import Mesh as TMesh

    def check(cfg):
        jcfg, _ = _configs(remat=False)
        with pytest.raises(ValueError) as want:
            jcall(jcfg, JMesh(np.array(jax.devices()[:3]).reshape(1, 3), ("data", "model")))
        with pytest.raises(ValueError) as got:
            tcall(cfg, TMesh(np.arange(3).reshape(1, 3), ("data", "model")))
        assert str(got.value) == str(want.value)
        assert "model axis size 3 must divide" in str(got.value)
    return check


@pytest.mark.parametrize("call", [
    _adamw8bit_state,
    _misused_mesh(lambda cfg, mesh: make_train_state(cfg, mesh, device="cpu"),
                  lambda cfg, mesh: jmake_train_state(jax.random.PRNGKey(0), cfg, mesh)),
    _adamw8bit_spec,
    _misused_mesh(lambda cfg, mesh: make_train_step(cfg, AdamW(1e-3), mesh),
                  lambda cfg, mesh: jstep(cfg, optax.adamw(1e-3), mesh)),
    _misused_mesh(lambda cfg, mesh: make_accum_train_step(cfg, AdamW(1e-3), mesh,
                                                          accum_steps=2),
                  lambda cfg, mesh: jaccum(cfg, optax.adamw(1e-3), mesh, accum_steps=2)),
], ids=[f"<lambda>{i}" for i in range(5)])  # the ids these cases have had
def test_unported_training_options_raise(call):
    """Mesh training and adamw8bit are ported: each case checks what the
    JAX package refuses of the option on both packages (a mesh whose model
    axis divides neither head count; an unknown optimizer name), with equal
    messages."""
    _, tcfg = _configs(remat=False)
    call(tcfg)
