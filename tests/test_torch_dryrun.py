"""The dry run's twins: ``perf/op_cost.py`` (of ``perf/jaxpr_cost.py``),
``perf/comm_stats.py`` (of ``perf/hlo_stats.py``), ``launch/dryrun.py`` and
``launch/recost.py``, and the kernel wrappers on the meta device.

* ``op_cost`` on the cases of ``tests/test_perf_tools.py``: matmul FLOPs
  exact, a loop of N products N times one, elementwise ops charge no bytes,
  a gradient 2–4× its forward.  Against the reference on the CPU: the matrix
  products of a ``TINY`` training forward count exactly the FLOPs of the
  ``dot_general`` equations of the reference's jaxpr of the same forward.
* ``comm_stats``: one mesh train step (ZeRO-1 off) on a fake 2×2 mesh
  all-gathers exactly the local shards of the parameters ``param_pspecs``
  splits, a figure this file computes from the spec tree.
* The twin of ``tests/test_dryrun_small.py``: minicpm-2b smoke on a fake 2×2
  mesh, all three modes, then ``recost`` rewrites their records; and one
  production cell, minicpm-2b ``train_4k`` on the fake 16×16 mesh (one
  microbatch, so it traces in seconds; the CLI's default is 8).
* The wrappers of ``flash_prefill``, ``gear_compress``, ``quant_pack`` and
  ``linear_scan_chunked`` return, on meta operands, what their plain
  versions return on the CPU, shape and dtype (``gear_decode`` and
  ``flash_prefill_block`` run on meta in the decode and prefill cells).

Every fake process group is destroyed before its test ends, so none leaks
into another test file on the same worker.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

import repro_torch.configs as C  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.perf.jaxpr_cost import _dot_flops  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.kernels import flash_prefill as fp_lib  # noqa: E402
from repro_torch.kernels import gear_compress as gc_lib  # noqa: E402
from repro_torch.kernels import linear_scan_kernel as ls_lib  # noqa: E402
from repro_torch.kernels import quant_pack as qp_lib  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.launch import recost  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, make_test_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import Transformer, forward_train  # noqa: E402
from repro_torch.perf.comm_stats import collective_stats, dtype_bytes  # noqa: E402
from repro_torch.perf.op_cost import OpCounter, op_histogram, trace_cost  # noqa: E402
from repro_torch.train.loop import make_train_step  # noqa: E402
from repro_torch.train.state import RunConfig, init_train_state  # noqa: E402

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
SMALL_SHAPES = {
    # 16 rows: one a microbatch for each of the 2 data groups' 8 microbatches
    "train_4k": dataclasses.replace(C.SHAPES["train_4k"], seq_len=64, global_batch=16),
    "prefill_32k": dataclasses.replace(C.SHAPES["prefill_32k"], seq_len=128, global_batch=2),
    "decode_32k": dataclasses.replace(C.SHAPES["decode_32k"], seq_len=128, global_batch=4),
}


@pytest.fixture
def no_group():
    """Asserts no process group is left behind."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
        pytest.fail("a process group leaked")


# -- op_cost ------------------------------------------------------------------


def test_matmul_flops_exact():
    c = trace_cost(lambda a, b: a @ b, torch.zeros(128, 256), torch.zeros(256, 64))
    assert c["flops"] == 2 * 128 * 256 * 64


def test_loop_multiplies_trip_count():
    def f(x):
        w = torch.ones(32, 32)
        for _ in range(7):
            x = x @ w
        return x
    assert trace_cost(f, torch.zeros(32, 32))["flops"] == 7 * 2 * 32 ** 3


def test_elementwise_zero_bytes():
    assert trace_cost(lambda x: torch.tanh(x) + 1.0, torch.zeros(1024, 1024))["bytes"] == 0.0


def test_grad_roughly_3x_forward():
    w = torch.zeros(64, 64, requires_grad=True)
    x = torch.zeros(128, 64)
    fwd = trace_cost(lambda w, x: ((x @ w) ** 2).sum(), w, x)["flops"]
    bwd = trace_cost(lambda w, x: torch.autograd.grad(((x @ w) ** 2).sum(), w), w, x)["flops"]
    assert 2.0 <= bwd / fwd <= 4.0


def test_inference_mode_and_meta_count_the_same():
    """A composite op under ``inference_mode`` (where it reaches the mode
    whole) is counted by the ops it runs, and meta operands as CPU ones."""
    def f(x, w):
        return (x.to(torch.bfloat16) @ w).float().softmax(-1)
    args = (torch.zeros(2, 4, 8), torch.zeros(8, 3, dtype=torch.bfloat16))
    meta = tuple(a.to("meta") for a in args)
    with torch.inference_mode():
        inf = trace_cost(f, *meta)
    assert inf == trace_cost(f, *args) and inf["flops"] > 2 * 8 * 8 * 3
    with OpCounter() as c:
        f(*args)
    assert dict(op_histogram(c.ops))["mm"] == 1


def _ref_dot_flops(jaxpr) -> float:
    """Sum of 2·M·N·K over the ``dot_general`` equations of a jaxpr, scans
    times their length, recursing into every sub-jaxpr."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            total += _dot_flops(eqn)
            continue
        mult = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += mult * _ref_dot_flops(inner)
    return total


def test_tiny_forward_matmul_flops_equal_the_reference_dot_generals():
    """The port's TINY training forward (batch 2, 16 tokens) counts, in its
    matrix products, exactly the FLOPs of the ``dot_general`` equations of
    the reference's ``forward(mode="train")`` of the same batch."""
    ref_cfg = RefModelConfig(**TINY)
    params = ref_tfm.init_params(ref_cfg, jax.random.PRNGKey(0))
    batch = {"tokens": jnp.zeros((2, 16), jnp.int32)}
    cj = jax.make_jaxpr(lambda p, b: ref_tfm.forward(ref_cfg, p, b, mode="train"))(params, batch)
    want = _ref_dot_flops(cj.jaxpr)
    model = Transformer(ModelConfig(**TINY), "meta", dtype=torch.float32)
    with OpCounter() as c:
        forward_train(model, torch.zeros((2, 16), dtype=torch.int32, device="meta"))
    assert want > 0 and c.matmul_flops == want


# -- comm_stats -----------------------------------------------------------------


def test_dtype_bytes():
    assert dtype_bytes(torch.bfloat16) == 2 and dtype_bytes("f32") == 4
    assert dtype_bytes("s4") == 0.5 and dtype_bytes("unknown") == 4


def test_mesh_train_step_all_gathers_the_split_parameters(no_group):
    """One mesh train step with ZeRO-1 off gathers each split parameter's
    local shard over ``model`` once, and nothing else."""
    cfg = C.smoke_config("minicpm-2b")
    dr.fake_group(4)
    try:
        mesh = make_test_mesh(2, 2, device="cpu")
        run = RunConfig(microbatches=1, remat=False, zero1=False, ckpt_every=0)
        state = init_train_state(Transformer(cfg, "meta", dtype=torch.float32), run, mesh)
        batch = {"tokens": torch.zeros((4, 32), dtype=torch.int32, device="meta")}
        st = collective_stats(make_train_step(build_model(cfg), run, mesh), state, batch)
        shapes = {n: tuple(p.shape) for n, p in Transformer(cfg, "meta").named_parameters()}
        sizes = axis_sizes(mesh)
    finally:
        dist.destroy_process_group()
    want, n_split = 0, 0
    for n, spec in shd.param_pspecs(cfg, shapes, mesh).items():
        split = int(np.prod([sizes[a] for e in spec for a in shd._axes_of(e)] or [1]))
        if split > 1:
            want += int(np.prod(shapes[n])) // split * 4
            n_split += 1
    assert st["all-gather"]["operand_bytes"] == want
    assert st["all-gather"]["count"] == n_split
    assert st["all-gather"]["result_bytes"] == 2 * want       # a model axis of 2
    assert st["total_count"] == st["all-gather"]["count"] + st["all-reduce"]["count"]


# -- the dry run ------------------------------------------------------------------


@pytest.fixture
def small_dryrun(monkeypatch, no_group):
    """``dryrun`` / ``recost`` on minicpm-2b's smoke config, small shapes and
    a fake 2×2 mesh."""
    smoke = C.smoke_config("minicpm-2b")
    monkeypatch.setattr(dr, "get_config", lambda name: smoke)
    monkeypatch.setattr(dr, "SHAPES", SMALL_SHAPES)
    fake = dr.fake_group
    monkeypatch.setattr(dr, "fake_group", lambda world: fake(4))
    monkeypatch.setattr(dr, "make_production_mesh",
                        lambda multi_pod=False, device=None: make_test_mesh(2, 2, device=device))


def test_dryrun_machinery_small_mesh(small_dryrun, tmp_path):
    """All three modes trace on a fake 2×2 mesh with compute > 0, FLOPs > 0
    and collectives; ``recost`` then rewrites every record's loop cost and
    roofline to what a fresh trace gives."""
    recs = dr.run_cells([("minicpm-2b", s) for s in SMALL_SHAPES], False, "gear_kcvt4",
                        str(tmp_path))
    for shape, rec in zip(SMALL_SHAPES, recs):
        assert "error" not in rec, rec
        assert rec["roofline"]["compute_s"] > 0, shape
        assert rec["loop_cost"]["flops"] > 0 and rec["loop_cost"]["matmul_flops"] > 0, shape
        assert rec["collectives"]["total_count"] > 0 and rec["collective_bytes"] > 0, shape
        mem = rec["memory"]
        assert mem["argument_size_in_bytes"] >= mem["param_bytes"] > 0, shape
        # the gathered weight copies are no argument; the engine holds one
        # layer's (and the embedding's) at a time, the train step all of them
        assert mem["argument_size_in_bytes"] == sum(mem[k] for k in dr.ARGUMENTS if k in mem)
        assert 0 < mem["gathered_peak_bytes"], shape
        assert rec["op_histogram"] and len(rec["op_histogram"]) <= 15
    paths = sorted(tmp_path.glob("*.json"))
    assert len(paths) == 3
    before = {p.name: json.loads(p.read_text()) for p in paths}
    for p in paths:
        rec = json.loads(p.read_text())
        rec["loop_cost"], rec["roofline"] = {}, {}
        p.write_text(json.dumps(rec))
    recost.main(["--out", str(tmp_path)])
    for p in paths:
        rec = json.loads(p.read_text())
        assert rec["loop_cost"] == before[p.name]["loop_cost"]
        assert rec["roofline"] == before[p.name]["roofline"]


def test_production_cell_minicpm_train_on_the_16x16_mesh(no_group):
    """minicpm-2b ``train_4k`` as rank 0 of 256 fake processes: every key of
    the record, this process's shard of the f32 parameters, ZeRO-1 moments,
    and the mesh step's collectives."""
    rec = dr.dryrun_cell("minicpm-2b", "train_4k", multi_pod=False, microbatches=1)
    assert not dist.is_initialized()
    cfg = C.get_config("minicpm-2b")
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    for key in ("loop_cost", "collectives", "collective_bytes", "memory", "roofline",
                "op_histogram"):
        assert key in rec
    mem = rec["memory"]
    # each process keeps at most its 1/16 model share of the split matrices
    assert mem["param_bytes"] < 4 * cfg.param_count() / 8
    assert mem["opt_bytes"] < mem["param_bytes"]
    assert rec["collectives"]["all-gather"]["count"] > 0
    assert rec["collectives"]["all-reduce"]["count"] > 0
    # every process runs the whole model on its 16 rows: 256 · 16 rows at
    # 6·N·D lower the executed FLOPs to at most 1/16 model-FLOP efficiency
    assert rec["roofline"]["model_flops"] > 0 and 0 < rec["roofline"]["flops_eff"] < 0.1


# -- the kernel wrappers on meta ------------------------------------------------


def _meta(*ts):
    return tuple(t.to("meta") if isinstance(t, torch.Tensor) else t for t in ts)


def _same_form(a, b):
    a, b = (a if isinstance(a, (tuple, list)) else (a,)), (b if isinstance(b, (tuple, list))
                                                          else (b,))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None:
            assert y is None
            continue
        assert y.device.type == "meta" and y.shape == x.shape and y.dtype == x.dtype


def test_wrappers_run_the_plain_version_on_meta():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, 16, generator=g).to(torch.bfloat16)
    k = torch.randn(2, 64, 16, generator=g).to(torch.bfloat16)
    _same_form(fp_lib.flash_prefill(q, k, k, kv_repeat=2),
               fp_lib.flash_prefill(*_meta(q, k, k), kv_repeat=2))
    x = torch.randn(3, 64, 16, generator=g)
    kw = dict(bits=4, scheme="per_channel", n_out=1)
    _same_form(gc_lib.gear_compress(x, **kw), gc_lib.gear_compress(*_meta(x), **kw))
    _same_form(qp_lib.quant_pack(x, 4), qp_lib.quant_pack(*_meta(x), 4))
    r = torch.randn(4, 32, 8, generator=g)
    lw = -torch.rand(4, 32, 8, generator=g)
    _same_form(ls_lib.linear_scan_chunked(r, r, r, lw, chunk=16),
               ls_lib.linear_scan_chunked(*_meta(r, r, r, lw), chunk=16))
