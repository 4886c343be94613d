"""The explicit expert-parallel MoE across ranks (``models.moe_a2a``, the
port of the reference's ``shard_map`` formulation) on 8 gloo ranks of the
CPU, against the reference's dense ``moe_block``: ``tests/test_moe_a2a.py``'s
case (qwen3-moe smoke, 8 experts top-2, capacity factor 8, x (2 D, 6, d)
from the reference's draws) at the meshes (4, 2) and (2, 4), the error
below 2e-5 and the aux below 1e-4, its bounds.  The experts are DTensors
laid out by the rules (experts over 'model'); each data rank gets its rows.
The gradients of sum(out * w) + aux (each data rank's part of the sum
times D plus the aux, averaged over 'data' as the train step averages)
are the reference's ``jax.grad`` of the dense block within 1e-4 of each
leaf's max (``tests/test_torch_moe.py``'s bound).  At (1, 8) the capacity
is the global one: the assignments dropped across the model ranks are the
dense block's (a binding capacity factor of 1)."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import mesh
from repro_torch.models import moe
from repro_torch.models.common import ParamBuilder
from repro_torch.models.moe_a2a import moe_block_a2a
from repro_torch.parallel import sharding
from repro_torch.parallel import tensor as tp

WORLD = 8
ARCH = "qwen3-moe-235b-a22b"
MESHES = ((4, 2), (2, 4))


def _tight(cfg):
    """The smoke config with a binding capacity (factor 1)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


def _placed(cfg, params, dmesh):
    pb = ParamBuilder(None)
    axes = pb.axes_of(moe.init_moe(pb, cfg))
    rules = sharding.make_rules(cfg, dmesh)
    return tp.place_tree({k: torch.tensor(np.array(v)) for k, v in params.items()},
                         sharding.param_shardings(dmesh, axes, rules))


def _grads(cfg, params, x, w, dmesh, d, rows, dn) -> dict:
    """Gradients of D * sum(out_d * w_d) + aux on data rank d, summed over
    'data' and divided by D (the train step's mean): the parameters'
    gathered whole, this rank's rows of x's divided by D."""
    import torch.distributed as dist

    from repro_torch.models.common import tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    xl = x[d * rows:(d + 1) * rows].clone().requires_grad_()
    out, aux = moe_block_a2a(live, xl, cfg, dmesh)
    loss = dn * torch.sum(out * w[d * rows:(d + 1) * rows]) + aux
    names = sorted(live)
    grads = torch.autograd.grad(loss, [live[n] for n in names] + [xl])
    g = {n: tp.local(gr).clone() for n, gr in zip(names, grads[:-1])}
    if dn > 1:
        for v in g.values():
            dist.all_reduce(v, group=dmesh.get_group("data"))
    g = {n: tp.full_tensor(tp.like(v / dn, live[n])) for n, v in g.items()}
    return dict(grads=g, x_grad=grads[-1] / dn)


def rank_cases(rank: int, world: int, store: str, ref: dict) -> dict:
    import torch.distributed as dist

    mesh.init_ranks(rank, world, device="cpu", store_path=store, timeout_s=120)
    cfg = get_config(ARCH, smoke=True)
    out = {}
    for dn, mn in MESHES:
        dmesh = mesh.make_device_mesh(dn, mn)
        d = dmesh.get_coordinate()[0]
        case = ref[f"{dn}x{mn}"]
        x = torch.as_tensor(case["x"])
        rows = x.shape[0] // dn
        params = _placed(cfg, case["params"], dmesh)
        got, aux = moe_block_a2a(params, x[d * rows:(d + 1) * rows], cfg, dmesh)
        # moe_block routes there once set_moe_opts names the mesh
        moe.set_moe_opts(a2a_mesh=dmesh)
        try:
            routed, _ = moe.moe_block(params, x[d * rows:(d + 1) * rows], cfg)
        finally:
            moe.set_moe_opts()
        out[f"{dn}x{mn}"] = dict(data=d, out=got, aux=float(aux),
                                 routed_same=bool(torch.equal(routed, got)),
                                 **_grads(cfg, params, x, torch.as_tensor(case["w"]), dmesh, d,
                                          rows, dn))

    # (1, 8) at a binding capacity: the drops of the dense block
    tight = _tight(cfg)
    dmesh = mesh.make_device_mesh(1, 8)
    case = ref["4x2"]
    moe.set_moe_opts(count_drops=True)
    moe_block_a2a.dropped = 0
    try:
        got, aux = moe_block_a2a(_placed(tight, case["params"], dmesh),
                                 torch.as_tensor(case["x"]), tight, dmesh)
    finally:
        moe.set_moe_opts()
    out["1x8"] = dict(out=got, aux=float(aux), dropped=int(moe_block_a2a.dropped))
    dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def reference():
    """tests/test_moe_a2a.py's inputs and the reference's dense block."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as get_config_jax
    from repro.models import moe as moe_jax
    from repro.models.common import ParamBuilder as ParamBuilderJax, unzip_params

    cfg = get_config_jax(ARCH, smoke=True)
    out = {}
    for dn, mn in MESHES:
        params, _ = unzip_params(moe_jax.init_moe(ParamBuilderJax(key=jax.random.PRNGKey(0)),
                                                  cfg))
        x = jax.random.normal(jax.random.PRNGKey(1), (dn * 2, 6, cfg.d_model),
                              jnp.float32) * 0.5
        y, aux = moe_jax.moe_block(params, x, cfg)
        w = np.random.default_rng(dn).standard_normal(y.shape).astype(np.float32)

        def f(p, xx):
            o, a = moe_jax.moe_block(p, xx, cfg)
            return jnp.sum(o * w) + a

        gp, gx = jax.grad(f, argnums=(0, 1))(params, x)
        out[f"{dn}x{mn}"] = dict(params=jax.tree.map(np.asarray, params), x=np.asarray(x),
                                 out=np.asarray(y), aux=float(aux), w=w,
                                 grads=jax.tree.map(np.asarray, gp), x_grad=np.asarray(gx))
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    return mesh.spawn_ranks(rank_cases, WORLD, reference, timeout_s=300)


@pytest.mark.parametrize("shape", MESHES)
def test_moe_a2a_matches_the_dense_reference(reference, ranks, shape):
    key = f"{shape[0]}x{shape[1]}"
    want = reference[key]
    rows = want["x"].shape[0] // shape[0]
    for out in ranks:
        got = out[key]
        ref = want["out"][got["data"] * rows:(got["data"] + 1) * rows]
        assert float(np.abs(got["out"].numpy() - ref).max()) < 2e-5, key
        assert abs(got["aux"] - want["aux"]) < 1e-4, key
        assert got["routed_same"]


@pytest.mark.parametrize("shape", MESHES)
def test_moe_a2a_gradients_match_the_dense_reference(reference, ranks, shape):
    key = f"{shape[0]}x{shape[1]}"
    want = reference[key]
    rows = want["x"].shape[0] // shape[0]
    for out in ranks:
        got = out[key]
        for name, g in got["grads"].items():
            ref = want["grads"][name]
            assert float(np.abs(g.numpy() - ref).max()) <= 1e-4 * float(np.abs(ref).max()), \
                (key, name)
        ref = want["x_grad"][got["data"] * rows:(got["data"] + 1) * rows]
        assert float(np.abs(got["x_grad"].numpy() - ref).max()) <= 1e-4 * float(
            np.abs(want["x_grad"]).max()), key


def test_moe_a2a_drops_what_the_dense_block_drops_on_one_data_rank(reference, ranks):
    """At (1, 8) the capacity is the global one: the sum of the ranks'
    drops is the dense block's at a binding capacity, and the output its."""
    cfg = _tight(get_config(ARCH, smoke=True))
    case = reference["4x2"]
    moe.set_moe_opts(count_drops=True)
    moe.moe_block.dropped = 0
    try:
        params = {k: torch.tensor(np.array(v)) for k, v in case["params"].items()}
        want, aux = moe.moe_block(params, torch.tensor(np.array(case["x"])), cfg)
    finally:
        moe.set_moe_opts()
    dropped = int(moe.moe_block.dropped)
    assert dropped > 0  # the capacity binds
    assert sum(out["1x8"]["dropped"] for out in ranks) == dropped
    for out in ranks:
        assert float((out["1x8"]["out"] - want).abs().max()) < 2e-5
        assert abs(out["1x8"]["aux"] - float(aux)) < 1e-4
