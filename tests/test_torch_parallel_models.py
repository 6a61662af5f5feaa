"""The port's mesh training and tensor-parallel serving against the JAX
package's, on the CPU.

One group of 4 gloo ranks (``parallel/launch.py``, one thread each; the
rank bodies are ``parallel/workloads.py``'s) runs, from the same
``ModelConfig.tiny(dtype=float32)`` weights and tokens as the JAX side:

- the dp 2 × tp 2 train step, two steps, without and with attention dropout
  (step seeds 3 and 4), and one step of an ALiBi model with dropout, against
  the JAX step.  With dropout on a RoPE model the JAX step is jitted over a
  (data 2, model 2) mesh of conftest's virtual devices: its partitioned
  attention folds each shard's coordinates into the seed, and so does the
  port.  Every other case is held to the JAX step's single-device twin,
  which computes the same values as its mesh run (a mesh compile costs ~3x
  one device's in interpret mode): without dropout the mesh changes no
  value, and JAX replicates an ALiBi call, so its dropout masks are the
  single-device ones (the port attends the whole batch and every head on
  each rank there).  Losses within rtol 1e-5, updated weights within atol
  3e-5 (test_torch_train.py's ADAM_ATOL) but for one in 10^4 at most, none
  past the steps' lr (Adam's first steps move a weight by a full lr·g/|g|
  whatever the summation order of a near-zero g);
- make_accum_train_step (2 microbatches) on the same mesh against JAX's;
- fit with a mesh and global-norm clipping (the norm summed over the model
  axis) against JAX's fit;
- a tp 2 DecodeEngine of an ALiBi model (each rank's slice of the global
  slopes; each of 2 data replicas a tp 2 group) against the JAX engine on
  a model-axis mesh: greedy tokens of generate, of
  generate(burst=4) and of generate_fused equal JAX's generate, and equal
  on every rank.

``dryrun_multichip(4)`` runs in a group of its own.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)
from jax.sharding import Mesh as JMesh

from flash_attention_dlrs_tpu.models import ModelConfig as JConfig
from flash_attention_dlrs_tpu.models import TrainSpec as JSpec
from flash_attention_dlrs_tpu.models import fit as jfit
from flash_attention_dlrs_tpu.models import init_params
from flash_attention_dlrs_tpu.models import make_accum_train_step as jaccum
from flash_attention_dlrs_tpu.models import make_train_step as jstep
from flash_attention_dlrs_tpu.models import param_shardings as jshardings
from flash_attention_dlrs_tpu.runtime.engine import DecodeEngine as JEngine
from flash_attention_dlrs_tpu_torch.models import ModelConfig as TConfig
from flash_attention_dlrs_tpu_torch.models import TrainSpec as TSpec
from flash_attention_dlrs_tpu_torch.parallel import launch as tlaunch
from flash_attention_dlrs_tpu_torch.parallel import workloads
from flash_attention_dlrs_tpu_torch.parallel.dryrun import dryrun_multichip

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs 4 (virtual) devices")

RTOL = 1e-5
ADAM_ATOL = 3e-5
LR = 3e-4
SEEDS = [3, 4]
PROMPTS = [[5, 7, 11, 13, 17], [3, 1, 4, 1, 5, 9, 2, 6]]
ENGINE_KW = dict(num_pages=32, page_size=128, num_slots=2, pages_per_seq=4)


def _cfgs(**kw):
    return (JConfig.tiny(dtype=jnp.float32, remat=True, **kw),
            TConfig.tiny(dtype=torch.float32, remat=True, **kw))


TREE = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), _cfgs()[0]))
ALIBI = dict(position_encoding="alibi")
ALIBI_DROPOUT = dict(ALIBI, attn_dropout=0.1)
TOKENS = np.random.default_rng(1).integers(0, 256, (4, 33)).astype(np.int32)
FIT_SPEC = dict(learning_rate=LR, grad_clip_norm=0.5)
TRAIN_CASES = [
    dict(name="step", cfg=_cfgs()[1], params=TREE, tokens=TOKENS, axes=[2, 2], steps=2,
         learning_rate=LR),
    dict(name="step_dropout", cfg=_cfgs(attn_dropout=0.1)[1], params=TREE, tokens=TOKENS,
         axes=[2, 2], steps=2, seeds=SEEDS, learning_rate=LR),
    dict(name="step_alibi_dropout", cfg=_cfgs(**ALIBI_DROPOUT)[1], params=TREE, tokens=TOKENS,
         axes=[2, 2], steps=1, seeds=SEEDS[:1], learning_rate=LR),
    dict(name="accum", cfg=_cfgs()[1], params=TREE, tokens=TOKENS, axes=[2, 2], kind="accum",
         accum_steps=2, steps=1, learning_rate=LR),
    dict(name="fit", cfg=_cfgs()[1], params=TREE, tokens=TOKENS, axes=[2, 2], kind="fit",
         steps=2, spec=TSpec(**FIT_SPEC)),
]
ENGINE_CASE = dict(name="engine", cfg=TConfig.tiny(dtype=torch.float32, remat=False, **ALIBI),
                   params=TREE, prompts=PROMPTS, new_tokens=6, axes=[2, 2],
                   names=("data", "model"), engine_kw=dict(ENGINE_KW, kv_dtype=torch.float32),
                   calls=("generate", "burst", "fused"))


@pytest.fixture(scope="module")
def group():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(tlaunch.launch, workloads.models_suite, 4, TRAIN_CASES, [ENGINE_CASE],
                      timeout=300, threads=1)
    pool.shutdown()


def _jmesh(axes, names=("data", "model")):
    return JMesh(np.array(jax.devices()[:int(np.prod(axes))]).reshape(axes), names)


def _jax_state(cfg, mesh):
    params = jax.tree.map(jnp.asarray, TREE)
    if mesh is not None:
        params = jax.tree.map(jax.device_put, params,
                              jshardings(params, mesh, n_kv_heads=cfg.n_kv_heads))
    opt = optax.adamw(LR, weight_decay=0.01)
    return params, opt.init(params), opt


def _check(rec, losses, params):
    """Losses within RTOL; weights within ADAM_ATOL (+ RTOL) but for at most
    one in 10^4 of a leaf, and none further than the run's steps · LR: Adam
    moves a weight whose gradient sits at the summation-order noise by a
    different fraction of a step in the two packages (test_torch_train.py,
    test_torch_optim.py)."""
    np.testing.assert_allclose(rec["losses"], np.asarray(losses), rtol=RTOL, atol=0)
    for a, b in zip(jax.tree.leaves(rec["params"]), jax.tree.leaves(params)):
        b = np.asarray(b)
        gap = np.abs(a - b)
        past = gap > ADAM_ATOL + RTOL * np.abs(b)
        assert past.sum() <= max(1, b.size // 10_000), (past.sum(), gap.max())
        assert gap.max() <= len(rec["losses"]) * LR, gap.max()


@pytest.mark.parametrize("name,kw,steps,jax_mesh", [  # the mesh compile first: it
    ("step_dropout", dict(attn_dropout=0.1), 2, True),   # overlaps the port's group
    ("step", {}, 2, False), ("step_alibi_dropout", ALIBI_DROPOUT, 1, False)])
def test_mesh_train_step_matches_jax(group, name, kw, steps, jax_mesh):
    jcfg = _cfgs(**kw)[0]
    mesh = _jmesh([2, 2]) if jax_mesh else None
    params, state, opt = _jax_state(jcfg, mesh)
    step = jstep(jcfg, opt, mesh)
    losses = []
    for s in SEEDS[:steps]:
        params, state, loss = step(params, state, jnp.asarray(TOKENS),
                                   *((jnp.int32(s),) if jcfg.attn_dropout else ()))
        losses.append(float(loss))
    _check(group.result()[0][name], losses, params)


def test_mesh_accum_step_matches_jax(group):
    jcfg = _cfgs()[0]
    mesh = None  # the single-device twin (see the module docstring)
    params, state, opt = _jax_state(jcfg, mesh)
    params, state, loss = jaccum(jcfg, opt, mesh, accum_steps=2)(params, state,
                                                                 jnp.asarray(TOKENS))
    _check(group.result()[0]["accum"], [float(loss)], params)


def test_mesh_fit_matches_jax(group):
    jcfg = _cfgs()[0]
    losses = []
    state = jfit(jcfg, iter([(TOKENS, None)] * 2), spec=JSpec(**FIT_SPEC), steps=2,
                 seed=0, on_step=lambda i, loss: losses.append(float(loss)))
    _check(group.result()[0]["fit"], losses, state["params"])


def test_every_rank_reports_the_global_loss(group):
    ranks = group.result()
    for name in ("step", "step_dropout", "step_alibi_dropout", "accum", "fit"):
        assert all(r[name]["losses"] == ranks[0][name]["losses"] for r in ranks)


def test_tp_engine_matches_jax_and_agrees_on_every_rank(group):
    jcfg = JConfig.tiny(dtype=jnp.float32, remat=False, **ALIBI)
    want = JEngine(jax.tree.map(jnp.asarray, TREE), jcfg, kv_dtype=jnp.float32,
                   mesh=_jmesh([2], ("model",)), **ENGINE_KW).generate(PROMPTS, max_new_tokens=6)
    for rank in group.result():
        eng = rank["engine"]
        for call in ("generate", "burst", "fused"):  # bursts and fused run eagerly
            assert eng["tokens"][call] == [list(map(int, t)) for t in want], call
        assert eng["all_ranks_equal"] and eng["pool_heads"] == jcfg.n_kv_heads // 2


def test_dryrun_multichip_runs_on_four_cpu_ranks():
    records = dryrun_multichip(4, device="cpu")
    assert [r["step"] for r in records] == ["train", "ring", "zigzag", "context_decode",
                                            "engine"]
    assert records[2]["oracle_err"] < 2e-4
