"""Port parity for the single-card tools: ``utils.roofline`` (the H100's
peaks; ``model_flops`` and ``wire_bytes`` against the reference's
``utils/roofline.py`` for every arch and shape and on the same collective
lists) and ``utils.trace`` (the reference's ``utils/hlo.py`` read from
PyTorch: collectives of a gloo process group in a ``torch.profiler`` trace,
and ``StepCosts``' counts of a smoke forward's products, exact), plus the
kernels' cost counts that the wrappers add under ``StepCosts`` and the
bounds in chip_smoke.py use."""

import _torch_env  # noqa: F401  (one torch thread; before torch is used)
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as get_config_jax
from repro.configs.shapes import SHAPES as SHAPES_JAX
from repro.utils import hlo as hlo_jax
from repro.utils import roofline as rl_jax
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import decode, fountain
from repro_torch.kernels.flash_attention import kernel as k4
from repro_torch.kernels.lt_decode import schedule
from repro_torch.models import build_model
from repro_torch.utils import roofline as rl
from repro_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    for name, shape in SHAPES.items():
        for n in (1, 8, 512):
            assert rl.model_flops(get_config(arch), shape, n) == rl_jax.model_flops(
                get_config_jax(arch), SHAPES_JAX[name], n)


def test_wire_bytes_and_roofline_terms_follow_the_reference():
    rng = np.random.default_rng(0)
    kinds = ["all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"]
    ops = [(kinds[rng.integers(5)], int(rng.integers(1, 1 << 30)), int(rng.integers(1, 17)))
           for _ in range(64)]
    port = [trace.CollectiveOp(kind=k, bytes=b, group_size=p) for k, b, p in ops]
    ref = [hlo_jax.CollectiveOp(kind=k, bytes=b, group_size=p) for k, b, p in ops]
    for i in range(len(ops) + 1):
        assert rl.wire_bytes(port[:i]) == rl_jax.wire_bytes(ref[:i])
    r = rl.derive({"flops": 3.3e12, "bytes accessed": 6.7e9}, port, 1e12, peak="fp32")
    assert r.compute_s == 3.3e12 / (495e12 / 3) and r.memory_s == 6.7e9 / 3.35e12
    assert r.collective_s == rl.wire_bytes(port) / 450e9 and r.dominant == "collective"
    assert r.roofline_fraction == 1e12 / (r.bound_s * rl.PEAKS["fp32"])
    assert r.useful_flops_ratio == 1e12 / 3.3e12 and r.to_dict()["peak"] == "fp32"
    assert rl.PEAKS == {"bf16": 989e12, "tf32": 495e12, "fp32": 165e12, "fp32_cores": 67e12}
    assert rl.derive({}, [], peak="bf16").dominant == "compute"


def test_no_tpu_figure_in_the_port_and_chip_smoke_takes_its_peaks_from_the_roofline():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    v5e = re.compile(r"\b(197e12|819e9|50e9|197\.0e12)\b")
    for f in files:
        assert not v5e.search(f.read_text()), f
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert "from repro_torch.utils.roofline import" in smoke
    assert not re.search(r"^(HBM_BYTES_PER_S|FP32_FLOPS|TF32_FLOPS) = ", smoke, re.M)


def test_parse_collectives_reads_a_gloo_group():
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        x = torch.ones(1000)
        out = [torch.empty(1000, dtype=torch.float64)]
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            dist.all_reduce(x)
            dist.all_gather(out, x.double())
            dist.barrier()
        ops = trace.parse_collectives(prof)
        summary = trace.collective_summary(prof.events())
    finally:
        dist.destroy_process_group()
    assert [(o.kind, o.bytes, o.group_size) for o in ops] == [("all-reduce", 4000, 1),
                                                             ("all-gather", 8000, 1)]
    assert summary == {"all-reduce": {"count": 1, "bytes": 4000},
                       "all-gather": {"count": 1, "bytes": 8000}}
    assert rl.wire_bytes(ops) == 0.0  # one rank moves nothing
    assert trace.parse_collectives(prof, group_size=4)[1].bytes == 4 * 8000


def test_step_costs_count_a_smoke_forwards_products_exactly():
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    B, T = 2, 16
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, size=(B, T)))
    with trace.StepCosts() as costs:
        model.forward(params, tok)
    d, hd, N = cfg.d_model, cfg.head_dim_, B * T
    per_layer = (2 * N * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd  # q, k, v
                 + 2 * N * cfg.n_heads * hd * d  # o
                 + 3 * 2 * N * d * cfg.d_ff  # swiglu
                 + 2 * 2 * B * cfg.n_heads * T * T * hd)  # the plain attention's two products
    assert costs.aten_flops == cfg.n_layers * per_layer + 2 * N * d * cfg.vocab  # + tied head
    assert costs.kernel_flops == 0 and costs.aten_bytes > 0 and not trace.counting()
    assert costs.cost_analysis() == {"flops": costs.flops, "bytes accessed": costs.bytes}


def test_kernel_counts_join_the_active_step_costs():
    assert not trace.counting()
    trace.count_kernel("flash_attention", 1.0, 2)  # nothing active: ignored
    with trace.StepCosts() as outer:
        with trace.StepCosts() as inner:
            f, b = k4.attention_costs(4, 24, 8, 1, 128, q_offset=1040, tk_valid=1041,
                                      causal=True, window=None, elem=4)
            trace.count_kernel("flash_attention", f, b)
            with trace.uncounted():
                torch.ones(8) @ torch.ones(8, 8)
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert inner.by_kernel["flash_attention"] == {"calls": 1, "flops": f, "bytes": b}
    assert inner.aten_flops == 0 and outer.aten_flops == 2 * 4 * 4 * 4
    assert outer.kernel_flops == f == 4.0 * 4 * 24 * 1041 * 128
    assert b == 2 * 4 * 24 * 128 * 4 + 2 * 4 * 8 * 1041 * 128 * 4
    fb, bb = k4.attention_bwd_costs(4, 24, 8, 1024, 1024, 128, q_offset=0, tk_valid=1024,
                                    causal=True, window=None, elem=4)
    assert fb == 10.0 * 4 * 24 * (1024 * 1025 // 2) * 128
    nq, nk = 4 * 24 * 1024 * 128, 4 * 8 * 1024 * 128
    assert bb == 4 * (3 * nq + 2 * nk + 4 * 24 * 1024) + 4 * (nq + 2 * nk)


@pytest.mark.parametrize("Tq,off,tkv,causal,window", [
    (64, 0, 64, True, None), (1, 1040, 1041, True, None), (70, 5, 75, True, 32),
    (37, 16, 53, False, None), (5, 3, 0, True, None), (16, -3, 32, True, None)])
def test_valid_pairs_counts_the_mask(Tq, off, tkv, causal, window):
    q = off + np.arange(Tq)[:, None]
    k = np.arange(max(tkv, 1))[None, :]
    m = (k < tkv) & ((k <= q) if causal else (q >= q.min()))
    if window is not None:
        m &= (q - k) < window
    assert k4.valid_pairs(Tq, off, tkv, causal, window) == int(m.sum())


@pytest.mark.parametrize("R,K,n_lost", [(64, 64, 8), (256, 256, 32)])
def test_k3_program_costs_equal_the_plan_count(R, K, n_lost):
    """K3's counts from its program alone equal those from the plan (each
    entry's coded block, the direct-filled blocks its neighbours and
    padding lists name, each recovered block once, the program's words)."""
    code = decode.make_decoder_code(R, K)
    keep = np.setdiff1d(np.arange(R + K), np.random.default_rng(R).choice(R, n_lost, False))
    plan = fountain.peel_decode_plan(code, keep)
    rounds = fountain.plan_rounds(plan)
    words = schedule.plan_program(plan, len(keep))
    L, elem = 256 * 64, 4
    read = {("c", int(c)) for r in rounds for c in r.coded}
    read |= {("s", int(s)) for r in rounds for s in r.nbr_idx[r.nbr_coef != 0]}
    named = {int(b) for r in schedule.read_program(words) for b in r.padding}
    named |= {s for kind, s in read if kind == "s"}
    inputs = len({c for kind, c in read if kind == "c"}) + len(named & set(
        plan.direct_src.tolist()))
    n_nbr = sum(int((r.nbr_coef != 0).sum()) for r in rounds)
    ops, nbytes = schedule.program_costs(words, L, elem)
    assert nbytes == (inputs + plan.n_peeled) * L * elem + words.size * 4
    assert ops == 2.0 * n_nbr * L + plan.n_peeled * L
