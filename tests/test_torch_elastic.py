"""Elastic shrink-and-restore across ``torch.distributed`` ranks
(``runtime.elastic.ElasticTrainer``, slice C5b): ``tests/test_elastic.py``
on 8 gloo ranks of the CPU.

phi4-mini smoke from the reference's init, AdamW (lr 3e-3, warmup 5, 200
steps, no decay), the synthetic stream's batches of 8 x 16 (the
reference's, drawn in the test process).  ``rebuild(model_axis=2)`` lays a
4 x 2 mesh over the 8 ranks; 12 steps save a checkpoint every 5;
``fail_device(7)`` leaves 7 ranks, a 3 x 2 mesh over ranks 0-5 (ranks 6
and 7 idle), restored from step 10; 8 more steps.  The global batch of 8
does not divide over 3 data ranks: each takes it whole, as the reference's
``batch_spec`` leaves it.

Beyond the reference test's assertions, the losses are the reference's
uninterrupted single-device run's (steps 0-11, then 10-17): the first
within 1e-5 relative, every later one within 1e-4 relative (AdamW carries
each step's rounding into the next); and the restored state equals the
state saved at step 10 bitwise."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.models import build_model
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as tp
from repro_torch.runtime.elastic import ElasticConfig, ElasticTrainer
from repro_torch.runtime.train_loop import make_train_step

WORLD = 8
ARCH = "phi4-mini-3.8b"
OPT = dict(lr=3e-3, warmup_steps=5, total_steps=200, weight_decay=0.0)
GB, T, STEPS = 8, 16, 18


def rank_run(rank: int, world: int, store: str, init, batches, ckpt_dir: str) -> dict:
    import torch.distributed as dist

    mesh.init_ranks(rank, world, device="cpu", store_path=store, timeout_s=180)
    model = build_model(get_config(ARCH, smoke=True))
    _, axes = model.init(None, with_axes=True)
    opt_cfg = adamw.AdamWConfig(**OPT)

    def build(dmesh):
        rules = sharding.make_rules(model.cfg, dmesh)
        params = interop.lm_params_from_numpy(model.cfg, init, "cpu")
        p_sh = sharding.param_shardings(dmesh, axes, rules)
        o_sh = sharding.opt_state_shardings(dmesh, axes, rules, params)
        p = tp.place_tree(params, p_sh)
        step = make_train_step(model, opt_cfg, 1, pre_shaped=True, device="cpu", mesh=dmesh)

        def step_fn(state, batch):
            p, o, metrics = step(state[0], state[1], batch)
            return (p, o), metrics

        return (p, adamw.init(p, o_sh)), step_fn, (p_sh, o_sh)

    saved = {}
    tr = ElasticTrainer(ElasticConfig(ckpt_dir=ckpt_dir, ckpt_every=5), build)

    def batch_fn(step, dmesh):
        if step == 10 and not saved:  # the state the step-10 checkpoint holds
            saved["state"] = tp.gather_tree(tr.state)
        return {k: torch.as_tensor(v) for k, v in batches[step].items()}

    tr.rebuild(model_axis=2)
    shape_a = tuple(tr.mesh.mesh.shape)
    losses_a = tr.run(12, batch_fn)
    step_before = tr.step
    tr.fail_device(7, model_axis=2)
    step_restored = tr.step
    restored = tp.gather_tree(tr.state) if tr.in_mesh() else None
    losses_b = tr.run(8, batch_fn)
    out = dict(losses_a=losses_a, losses_b=losses_b, resumed_step=step_before,
               step_after_restore=step_restored, mesh_a=shape_a,
               mesh_shape=tuple(tr.mesh.mesh.shape), in_mesh=tr.in_mesh())
    if rank == 0:
        out.update(saved=saved["state"], restored=restored)
    dist.barrier()
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    """The reference's init, its synthetic batches and its uninterrupted
    single-device run of 18 steps (jitted ``make_train_step``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_config_jax
    from repro.data import SyntheticLM
    from repro.models import build_model as build_model_jax
    from repro.optim import adamw as adamw_jax
    from repro.runtime.train_loop import make_train_step as make_train_step_jax

    cfg = get_config_jax(ARCH, smoke=True)
    model = build_model_jax(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, params)
    data = SyntheticLM(cfg.vocab, T, GB, n_micro=1, seed=0)
    batches = [data.batch(s) for s in range(STEPS)]
    step = jax.jit(make_train_step_jax(model, adamw_jax.AdamWConfig(**OPT), 1,
                                       pre_shaped=True))
    opt, losses = adamw_jax.init(params), []
    for b in batches:
        params, opt, m = step(params, opt, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return dict(init=init, batches=batches, losses=np.asarray(losses))


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    return mesh.spawn_ranks(rank_run, WORLD, reference["init"], reference["batches"],
                            str(tmp_path_factory.mktemp("elastic")), timeout_s=400)


def test_elastic_failover_resume(ranks):
    """tests/test_elastic.py's assertions, on rank 0."""
    out = ranks[0]
    assert out["mesh_a"] == (4, 2)
    assert out["step_after_restore"] <= out["resumed_step"]
    assert out["step_after_restore"] >= 5
    assert int(np.prod(out["mesh_shape"])) < 8 and out["mesh_shape"] == (3, 2)
    la, lb = out["losses_a"], out["losses_b"]
    assert len(la) == 12 and len(lb) == 8
    assert all(x == x and x < 1e4 for x in lb)
    assert lb[0] < la[0] + 1.0, "post-restore loss must not blow up"
    assert lb[-1] < la[0]


def test_losses_follow_the_uninterrupted_reference_run(reference, ranks):
    want = reference["losses"]
    for out in ranks[:6]:
        assert out["step_after_restore"] == 10
        la, lb = np.asarray(out["losses_a"]), np.asarray(out["losses_b"])
        assert abs(la[0] - want[0]) <= 1e-5 * abs(want[0])
        np.testing.assert_allclose(la, want[:12], rtol=1e-4, atol=0)
        np.testing.assert_allclose(lb, want[10:18], rtol=1e-4, atol=0)


def test_ranks_left_out_of_the_mesh_idle(ranks):
    for r, out in enumerate(ranks):
        assert out["in_mesh"] == (r < 6)
        assert (len(out["losses_b"]) == 8) == (r < 6) and len(out["losses_a"]) == 12


def test_restored_state_equals_the_saved_one_bitwise(ranks):
    saved, restored = ranks[0]["saved"], ranks[0]["restored"]
    assert saved[1].step == restored[1].step == 10
    pairs = tree_map(lambda a, b: torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b,
                     saved, restored)
    assert all(tree_leaves(pairs))
