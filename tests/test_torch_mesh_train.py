"""Training on a device mesh over ``torch.distributed`` (gloo, CPU
processes): the port's mesh step against its one-device step, the storage
each process keeps, checkpoint / restore on the mesh and onto another mesh,
and PowerSGD across a ``pod`` axis.

minicpm-2b's smoke config, ``seq_len`` 32, global batch 4 in 2
microbatches.  Two spawns share the cases: four processes on a 2×2
(data × model) mesh, then on a 4×1 mesh in the same job, and two on a
pod 2 × data 1 × model 1 mesh.  Each process rendezvouses through a
``FileStore`` in ``tmp_path``; the spawn joins with a timeout and kills its
children when it runs out, so a hung collective fails here.

Limits: each loss within ``LOSS_RTOL`` 1e-4 relative of the one-device
step's (the mean over the data group sums in another order); 6 steps
straight against 3 + save + restore + 3 within ``RESTORE_ATOL`` 1e-5, the
reference's bound; the elastic restore and the storage byte counts exact;
the step's PowerSGD mean within ``PSGD_ATOL`` 1e-5 of a one-process
``compressed_psum`` of the same per-pod gradients.
"""

import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import torch.distributed as dist  # noqa: E402

from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.synthetic import DataConfig, make_batch  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, make_test_mesh  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import grad_compress as gc_lib  # noqa: E402
from repro_torch.train import loop as loop_lib  # noqa: E402
from repro_torch.train.state import RunConfig, init_train_state, train_state_shardings  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCH = "minicpm-2b"
DATA = dict(seed=0, seq_len=32, global_batch=4)
SPAWN_TIMEOUT = 240.0
LOSS_RTOL = 1e-4
RESTORE_ATOL = 1e-5
PSGD_ATOL = 1e-5
PSGD = dict(grad_compression="powersgd", powersgd_rank=8, powersgd_min_size=4096)


def make_run(ckpt_dir, total: int, **kw) -> RunConfig:
    return RunConfig(total_steps=total, warmup_steps=1, microbatches=2, remat=True,
                     zero1=True, ckpt_dir=str(ckpt_dir), ckpt_every=0, log_every=1, **kw)


def setup():
    cfg = smoke_config(ARCH)
    return cfg, build_model(cfg), DataConfig(vocab_size=cfg.vocab_size, **DATA)


def spawn(tmp_path: pathlib.Path, world: int, worker: str) -> list:
    """Run ``worker`` in ``world`` fresh processes of one gloo job; return
    each rank's result.  Kills every child when ``SPAWN_TIMEOUT`` runs out."""
    out = tmp_path / worker
    out.mkdir()
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path.insert(0, {str(TESTS)!r}); import {__name__} as t; "
                f"t._child({rank}, {world}, {str(out)!r}, {worker!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"{worker}: the {world} processes did not finish in {SPAWN_TIMEOUT} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"{worker} rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _child(rank: int, world: int, out: str, worker: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                            rank=rank, world_size=world)
    try:
        result = WORKERS[worker](rank, pathlib.Path(out))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _spec_bytes(specs: dict, shapes: dict, mesh) -> int:
    """f32 bytes of one process's share of every leaf under ``specs``."""
    sizes = axis_sizes(mesh)
    total = 0
    for n, spec in specs.items():
        split = int(np.prod([sizes[a] for e in spec for a in shd._axes_of(e)] or [1]))
        total += int(np.prod(shapes[n])) // split * 4
    return total


def _global(state, shardings) -> dict:
    """Every leaf of ``state`` gathered to its global array (a collective)."""
    shs = ck._by_name(shardings)
    return {name: (shs[name].full(t) if name in shs else t).cpu().numpy()
            for name, t in ck._leaves(state)}


def _mesh_worker(rank: int, out: pathlib.Path) -> dict:
    """2×2: three steps, the storage, 6 straight ≡ 3 + save + restore + 3;
    then a 4×1 mesh restores the step-3 checkpoint."""
    cfg, model, dc = setup()
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    run = make_run(out / "unused", 6)
    state = init_train_state(model.init(seed=0, device="cpu", dtype=torch.float32), run, mesh)
    shapes = loop_lib.global_shapes(cfg)
    res["param_bytes"] = sum(p.numel() * p.element_size() for p in state.params.parameters())
    res["moment_bytes"] = sum(t.numel() * t.element_size()
                              for t in list(state.opt.mu.values()) + list(state.opt.nu.values()))
    res["param_bytes_want"] = _spec_bytes(shd.param_pspecs(cfg, shapes, mesh), shapes, mesh)
    res["moment_bytes_want"] = 2 * _spec_bytes(shd.zero1_pspecs(cfg, shapes, mesh), shapes, mesh)
    res["wq_shape"] = tuple(state.params.blocks[0].wq.shape)
    step = loop_lib.make_train_step(model, run, mesh)
    res["losses"] = []
    for s in range(3):
        state, met = step(state, make_batch(dc, cfg, s, "cpu"))
        res["losses"].append(float(met["loss"]))
    res["bytes_after_steps"] = (
        sum(p.numel() * p.element_size() for p in state.params.parameters()),
        sum(t.numel() * t.element_size()
            for t in list(state.opt.mu.values()) + list(state.opt.nu.values())))

    def loop(name, total, m=mesh):
        return loop_lib.train_loop(model, make_run(out / name, total), dc,
                                   log_fn=lambda *_: None, mesh=m)

    sh22 = train_state_shardings(cfg, mesh, run)
    straight = _global(loop("a", 6), sh22)
    first = loop("b", 3)
    ck.save(str(out / "b"), 3, first, sh22)
    resumed = loop("b", 6)
    res["resumed_step"] = resumed.step
    got = _global(resumed, sh22)
    res["restore_max_diff"] = max(float(np.abs(got[n] - straight[n]).max())
                                  for n in straight if n.startswith("params."))

    mesh41 = make_test_mesh(4, 1, device="cpu")
    sh41 = train_state_shardings(cfg, mesh41, run)
    fresh = init_train_state(model.init(seed=1, device="cpu", dtype=torch.float32), run, mesh41)
    back = ck.restore(str(out / "b"), 3, fresh, sh41)
    res["elastic_step"] = back.step
    res["elastic_moment_shape"] = tuple(back.opt.mu["embed"].shape)
    elastic = _global(back, sh41)
    res["elastic"] = elastic if rank == 0 else None
    return res


def _pod_worker(rank: int, out: pathlib.Path) -> dict:
    """pod 2 × data 1 × model 1, PowerSGD: one step, the inputs and output
    of its ``compressed_psum`` recorded."""
    cfg, model, dc = setup()
    mesh = make_test_mesh(1, 1, pod=2, device="cpu")
    run = make_run(out / "unused", 6, **PSGD)
    seen = {}
    real = loop_lib.compressed_psum

    def record(grads, ef, ccfg, group, inits):
        seen["grads"] = {n: g.clone() for n, g in grads.items()}
        seen["ef"] = {n: e.clone() for n, e in ef.items()}
        seen["inits"] = inits
        seen["ccfg"] = ccfg
        mean, new_ef, met = real(grads, ef, ccfg, group, inits)
        seen["mean"] = {n: g.clone() for n, g in mean.items()}
        return mean, new_ef, met

    loop_lib.compressed_psum = record
    try:
        state = init_train_state(model.init(seed=0, device="cpu", dtype=torch.float32), run,
                                 mesh)
        state, met = loop_lib.make_train_step(model, run, mesh)(state, make_batch(dc, cfg, 0,
                                                                                   "cpu"))
    finally:
        loop_lib.compressed_psum = real
    return {"metrics": {k: float(v) for k, v in met.items()}, **seen}


WORKERS = {"mesh": _mesh_worker, "pods": _pod_worker}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    return root, spawn(root, 4, "mesh")


@pytest.fixture(scope="module")
def pod_run(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("pods"), 2, "pods")


def thread_pods(fn, per_pod: list) -> list:
    """``fn(group, *args)`` for each pod's args, the pods as threads of this
    process, each with its own gloo process group over an in-process store."""
    store, out, errors = dist.HashStore(), [None] * len(per_pod), []

    def run(rank):
        try:
            out[rank] = fn(dist.ProcessGroupGloo(store, rank, len(per_pod)), *per_pod[rank])
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(len(per_pod))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if errors:
        raise errors[0]
    assert all(o is not None for o in out), "a pod did not finish"
    return out


def test_mesh_steps_match_the_one_device_step(mesh_run, tmp_path):
    cfg, model, dc = setup()
    run = make_run(tmp_path, 6)
    state = init_train_state(model.init(seed=0, device="cpu", dtype=torch.float32), run)
    step = loop_lib.make_train_step(model, run)
    want = []
    for s in range(3):
        state, met = step(state, make_batch(dc, cfg, s, "cpu"))
        want.append(float(met["loss"]))
    for rank, res in enumerate(mesh_run[1]):
        np.testing.assert_allclose(res["losses"], want, rtol=LOSS_RTOL, err_msg=f"rank {rank}")


def test_each_process_stores_its_share(mesh_run):
    cfg = smoke_config(ARCH)
    for res in mesh_run[1]:
        assert res["param_bytes"] == res["param_bytes_want"]
        assert res["moment_bytes"] == res["moment_bytes_want"]
        assert res["bytes_after_steps"] == (res["param_bytes"], res["moment_bytes"])
        assert res["wq_shape"] == (cfg.d_model, cfg.q_dim // 2)
        # the whole model is larger than any process's share
        assert res["param_bytes"] < 4 * sum(int(np.prod(s)) for s in
                                            loop_lib.global_shapes(cfg).values())


def test_restore_equals_straight_on_the_mesh(mesh_run):
    for res in mesh_run[1]:
        assert res["resumed_step"] == 6
        assert res["restore_max_diff"] < RESTORE_ATOL


def test_elastic_restore_onto_another_mesh_is_bit_equal(mesh_run):
    root, results = mesh_run
    d = root / "mesh" / "b" / "step_00000003"
    import json
    metas = json.loads((d / "manifest.json").read_text())["leaves"]
    got = results[0]["elastic"]
    assert [m["name"] for m in metas] == list(got)
    for i, m in enumerate(metas):
        want = np.load(d / f"arr_{i}.npy")
        np.testing.assert_array_equal(got[m["name"]].reshape(want.shape), want,
                                      err_msg=m["name"])
    cfg = smoke_config(ARCH)
    for res in results:
        assert res["elastic_step"] == 3
        # the size-1 model axis keeps embed's vocab dim: ZeRO-1 splits d_model 4 ways
        assert res["elastic_moment_shape"] == (cfg.vocab_size, cfg.d_model // 4)


def test_powersgd_step_compresses_across_pods(pod_run):
    for res in pod_run:
        met = res["metrics"]
        assert met["compressed_bytes"] > 0 and met["n_dev"] == 2.0
        assert np.isfinite(met["loss"]) and met["exact_bytes"] > 0
    a, b = (r["grads"] for r in pod_run)
    assert any(not torch.equal(a[n], b[n]) for n in a)   # the pods saw different rows


def test_powersgd_mean_equals_a_one_process_compressed_psum(pod_run):
    ccfg = pod_run[0]["ccfg"]
    want = thread_pods(lambda g, grads, ef, inits: gc_lib.compressed_psum(grads, ef, ccfg, g,
                                                                          inits)[0],
                       [(r["grads"], r["ef"], r["inits"]) for r in pod_run])
    for rank, res in enumerate(pod_run):
        assert list(res["mean"]) == list(want[rank])
        for n, g in res["mean"].items():
            torch.testing.assert_close(g, want[rank][n], rtol=0, atol=PSGD_ATOL)
    for n in pod_run[0]["mean"]:           # every pod holds the same mean
        torch.testing.assert_close(pod_run[0]["mean"][n], pod_run[1]["mean"][n], rtol=0,
                                   atol=PSGD_ATOL)


def test_mesh_world_size_and_device_are_checked():
    """A mesh larger than the job raises naming the world size it needs; a
    mesh on CUDA (the default) raises on a host without it, and nothing
    falls back to the CPU."""
    with pytest.raises(RuntimeError, match="world size of 4.*torchrun --nproc-per-node 4"):
        make_test_mesh(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_test_mesh(1, 1)
    assert not dist.is_initialized()
