"""Data parallelism of the port (parallel/distributed.py and the trainer's
steps under a process group) on 2 gloo ranks on the CPU, spawned once for
the module with a file:// rendezvous in a temporary directory.

Stage 0: both ranks start from the JAX trainer's parameters and grid, each
takes the draws of its shard of JAX's sharded step (its per-shard key,
split as JAX's ``_loss_and_metrics`` splits it) and steps.  The all-reduced
gradient equals the in-process mean of the two ranks' gradients, and the
parameters after Adam an in-process Adam step on it, within atol 1e-6.
Against JAX (``Trainer(cfg, mesh=make_mesh((2,)))`` on the conftest's
virtual CPU devices): each rank's loss matches its shard's (rtol 1e-4),
the mean gradient the mean of the shards' gradients with
tests/test_torch_slice.py's tolerances (tests/test_parallel.py holds
JAX's sharded step to that mean), and the reduced loss and point count
JAX's sharded step's metrics.  19 more steps with the ranks' own draws,
a grid update and the probes leave both ranks bit-equal.

Stage 1: one step on a small sphere mesh equals the in-process mean of the
ranks' crop gradients, the face errors are the sum of both ranks'; after a
refine both ranks hold the same mesh.  The CLI under 2 ranks writes one
set of checkpoints, one mesh and one stage-1 export, and a --mesh_shape
that is not the world size raises on every rank.  A 1-rank process group
gives the single-device trainer bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nerf2mesh_tpu_torch.config import Config as TConfig
from nerf2mesh_tpu_torch.data.provider import load_nerf_dataset
from nerf2mesh_tpu_torch.models.renderer import RenderState
from nerf2mesh_tpu_torch.utils.convert import load_params, params_from_jax
from nerf2mesh_tpu_torch.utils.trainer import Trainer

N_RAYS = 256
SCENE = dict(H=32, W=32, n_train=6, n_val=1, n_test=1)
S1_STEPS = 24              # the stage-1 run ends at this global step
S1_REFINE = 23             # ... refining before the step that reaches it


def tiny(cls, root="", **kw):
    base = dict(bound=1.0, scale=0.8, dt_gamma=0.0, num_rays=N_RAYS,
                num_points=4096, grid_size=32, num_levels=6,
                log2_hashmap_size=14, random_image_batch=True,
                background="random", mark_untrained=True,
                adaptive_num_rays=True, diffuse_step=1000,
                stochastic_fine=False)
    base.update(kw)
    return dataclasses.replace(cls(path=root), **base).finalize()


def stage1_cfg(cfg):
    return dataclasses.replace(cfg, stage=1, s1_crop=16, refine=True,
                               refine_steps=(S1_REFINE,), iters=S1_STEPS,
                               n_ckpt=1)


def icosphere():
    from nerf2mesh_tpu_torch.entry import uv_sphere
    v, f = uv_sphere()
    return v * 0.8, f


def _named_grads(params):
    return {k: p.grad.detach().clone() for k, p in params}


# ------------------------------------------------------------ the ranks
def _stage0(rank, n, inp, ws, out):
    from nerf2mesh_tpu_torch.parallel import distributed
    cfg = tiny(TConfig, inp["root"])
    t = Trainer(cfg, device="cpu", workspace=ws)
    load_params(t.params, inp["params"])
    t.render = RenderState(*[torch.from_numpy(a) for a in inp["render"]],
                           inp["iter_density"])
    ds = load_nerf_dataset(cfg, "train")
    images, poses, intr = t._prep_train_arrays(ds)
    draws = inp["draws"][rank]
    with torch.no_grad():
        loss, _ = t._loss_and_metrics(t.params, t.render, images, poses,
                                      intr, t.dynamics(0), N_RAYS // n, draws)
    m = t.train_step(images, poses, intr, N_RAYS, t.dynamics(0), draws=draws)
    out["loss_local"] = float(loss)
    out["metrics"] = {k: v.numpy().copy() for k, v in m.items()}
    out["grads"] = _named_grads(t.params.named_parameters())
    out["params1"] = {k: p.detach().clone()
                      for k, p in t.params.named_parameters()}
    out["seeds"] = (t.generator.initial_seed(),
                    t.grid_generator.initial_seed())
    t.train_steps(ds, 19)
    out["after"] = dict(
        digest=distributed.digest(
            list(t.params.parameters()) + list(t.ema_params.values())
            + [t.render.density_grid, t.render.occ_grid]),
        step=t.step, num_rays=t.num_rays, iter_density=t.render.iter_density,
        gather=t.net_spec.encode_gather_levels)
    return t, ds


def _stage1(rank, t, ds, ws, out):
    from nerf2mesh_tpu_torch.meshing.io import write_ply
    from nerf2mesh_tpu_torch.parallel import distributed
    if rank == 0:
        os.makedirs(os.path.join(ws, "mesh_stage0"))
        write_ply(os.path.join(ws, "mesh_stage0", "mesh_0.ply"), *icosphere())
    distributed.barrier()
    t.cfg = stage1_cfg(t.cfg)
    t.setup_stage1(ds)
    images, poses, intr = t._prep_train_arrays(ds)
    mvps = torch.from_numpy(ds.mvps)
    out["s1_params0"] = {k: p.detach().clone()
                         for k, p in t._named_params().items()}
    draws = t.stage1_draw(*images.shape[:3])
    out["s1_draws"] = draws
    m = t.stage1_step(images, poses, mvps, intr, draws=draws)
    out["s1_loss"] = float(m["loss"])
    out["s1_grads"] = _named_grads(t._named_params().items())
    # the face errors and counts before and after each sum over the ranks
    # (the refine's)
    reduced = out["s1_reduced"] = []
    real_sum = distributed.all_reduce_sum

    def recording_sum(x):
        before = x.clone()
        real_sum(x)
        reduced.append((before, x.clone()))
        return x
    distributed.all_reduce_sum = recording_sum
    faces0 = t.stage1_mesh.num_faces
    try:
        t.train_stage1(ds, None, max_steps=S1_STEPS)
    finally:
        distributed.all_reduce_sum = real_sum
    out["s1_after"] = dict(
        faces0=faces0, refines=t.stats.get("refines"), step=t.step,
        vertices=t.stage1_mesh.vertices.copy(),
        triangles=t.stage1_mesh.triangles.copy(),
        digest=distributed.digest(list(t._named_params().values())))


CLI = ["--bound", "1", "--scale", "0.8", "--dt_gamma", "0", "--num_rays",
       "256", "--num_points", "4096", "--grid_size", "32", "--num_levels",
       "6", "--grid_layout", "ref", "--log2_hashmap_size", "14",
       "--random_image_batch", "--mark_untrained", "--lr", "0.05",
       "--n_eval", "1", "--n_ckpt", "1", "--test_no_video"]


def _cli(root, ws, out):
    from nerf2mesh_tpu_torch.main import main
    argv = [root, "--workspace", ws] + CLI
    t0 = main(argv + ["--iters", "16", "--mcubes_reso", "32"], device="cpu")
    t1 = main(argv + ["--stage", "1", "--iters", "4", "--refine",
                      "--refine_steps_ratio", "0.5", "--texture_size", "64"],
              device="cpu")
    out["cli"] = dict(step0=t0.step, step1=t1.step,
                      refines=t1.stats.get("refines"))
    try:
        main(argv + ["--iters", "16", "--mesh_shape", "3"], device="cpu")
    except ValueError as e:
        out["cli"]["mismatch"] = str(e)


def _rank_main(rank, n, workdir):
    from nerf2mesh_tpu_torch.parallel import distributed
    torch.set_num_threads(1)
    distributed.init_distributed(
        "cpu", init_method=f"file://{os.path.join(workdir, 'init')}",
        rank=rank, world_size=n)
    try:
        inp = torch.load(os.path.join(workdir, "input.pt"), weights_only=False)
        out = {"world": distributed.world_size(), "rank": distributed.rank()}
        t, ds = _stage0(rank, n, inp, os.path.join(workdir, "ws"), out)
        _stage1(rank, t, ds, os.path.join(workdir, "ws"), out)
        _cli(inp["root"], os.path.join(workdir, "cli"), out)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ JAX's step
def _jax_reference(root, workspace):
    """The sharded step's per-shard draws, losses and mean gradient, and
    its reduced metrics, from JAX's trainer on a 2-device mesh."""
    import jax

    from nerf2mesh_tpu.config import Config as JConfig
    from nerf2mesh_tpu.data.provider import load_nerf_dataset as jload
    from nerf2mesh_tpu.parallel.sharding import make_mesh
    from nerf2mesh_tpu.utils import trainer as jtr

    jcfg = tiny(JConfig, root, workspace=workspace)
    jds = jload(jcfg, "train")
    mesh = make_mesh((2,), ("data",), devices=jax.devices("cpu")[:2])
    jt = jtr.Trainer(jcfg, mesh=mesh)
    jt.mark_untrained(jds)
    jt.update_grid(0)
    st = jt.state
    images, poses = jax.numpy.asarray(jds.images), jax.numpy.asarray(jds.poses)
    intr = jax.numpy.asarray(jds.intrinsics)
    dyn = jt.dynamics(0)
    per = N_RAYS // 2
    B, H, W, _ = jds.images.shape
    # the step's keys (trainer.py _build_step): state.key -> skey -> one a
    # shard, each split five ways in _loss_and_metrics
    _, skey = jax.random.split(st.key)
    keys = jax.random.split(skey, 2)

    def shard_loss(p, k):
        return jt._loss_and_metrics(p, st.render, k, images, poses, intr,
                                    None, dyn, per)

    vg = jax.jit(jax.value_and_grad(shard_loss, has_aux=True))
    draws, losses, grads = [], [], []
    for k in keys:
        (loss, _), g = vg(st.params, k)
        losses.append(float(loss))
        grads.append(params_from_jax(g))
        k_img, k_pix, k_bg, k_march, _ = jax.random.split(k, 5)
        draws.append({
            "img_idx": torch.tensor(np.asarray(
                jax.random.randint(k_img, (per,), 0, B))),
            "pix_idx": torch.tensor(np.asarray(
                jax.random.randint(k_pix, (per,), 0, H * W))),
            "bg": torch.tensor(np.asarray(jax.random.uniform(k_bg, (per, 3)))),
            "u": torch.tensor(np.asarray(jax.random.uniform(
                k_march, (per, jcfg.samples_per_ray))))})
    r = st.render
    ref = dict(
        params=params_from_jax(st.params), draws=draws, losses=losses,
        mean_grad={k: (grads[0][k] + grads[1][k]) / 2 for k in grads[0]},
        render=[np.array(r.density_grid), np.array(r.occ_grid),
                np.array(r.mean_density)],
        iter_density=int(r.iter_density))
    # the sharded step itself (it donates the state: last)
    _, m = jt.step_fn_for(N_RAYS)(st, images, poses, intr, None, dyn)
    ref["sharded"] = {k: np.asarray(v) for k, v in m.items()}
    return ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from nerf2mesh_tpu.data.synthetic import generate_synthetic_dataset
    base = tmp_path_factory.mktemp("dp")
    root = generate_synthetic_dataset(str(base / "scene"), **SCENE)
    ref = _jax_reference(root, str(base / "jax_ws"))
    workdir = str(base / "ranks")
    os.makedirs(workdir)
    torch.save({"root": root, "params": ref["params"],
                "draws": ref["draws"], "render": ref["render"],
                "iter_density": ref["iter_density"]},
               os.path.join(workdir, "input.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, 2, workdir))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(400)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not any(alive) and [p.exitcode for p in procs] == [0, 0], \
        (alive, [p.exitcode for p in procs])
    outs = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    return dict(root=root, ref=ref, outs=outs, workdir=workdir)


def _trainer(root, **kw):
    t = Trainer(tiny(TConfig, root, **kw), device="cpu")
    assert t.world == 1
    return t


# ------------------------------------------------------------ the tests
def test_stage0_step_is_the_mean_of_the_ranks(ranks):
    ref, outs = ranks["ref"], ranks["outs"]
    assert [o["world"] for o in outs] == [2, 2]
    assert [o["rank"] for o in outs] == [0, 1]
    t = _trainer(ranks["root"])
    t.pool_size //= 2            # each rank pools half the point budget
    load_params(t.params, ref["params"])
    t.render = RenderState(*[torch.from_numpy(a) for a in ref["render"]],
                           ref["iter_density"])
    ds = load_nerf_dataset(t.cfg, "train")
    images, poses, intr = t._prep_train_arrays(ds)
    grads = []
    for r in range(2):
        t.optimizer.zero_grad(set_to_none=True)
        loss, _ = t._loss_and_metrics(t.params, t.render, images, poses,
                                      intr, t.dynamics(0), N_RAYS // 2,
                                      ref["draws"][r])
        loss.backward()
        assert float(loss.detach()) == outs[r]["loss_local"]
        grads.append({k: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone())
                      for k, p in t.params.named_parameters()})
    for k, p in t.params.named_parameters():
        mean = (grads[0][k] + grads[1][k]) / 2
        for o in outs:
            np.testing.assert_allclose(o["grads"][k].numpy(), mean.numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
        p.grad = mean
    t.optimizer.step()
    for k, p in t.params.named_parameters():
        for o in outs:
            np.testing.assert_allclose(o["params1"][k].numpy(),
                                       p.detach().numpy(), atol=1e-6, rtol=0,
                                       err_msg=k)


def test_stage0_ranks_match_jax_sharded_step(ranks):
    ref, outs = ranks["ref"], ranks["outs"]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["loss_local"], ref["losses"][r],
                                   rtol=1e-4)
    sharded = ref["sharded"]
    for o in outs:
        np.testing.assert_allclose(o["metrics"]["loss"], sharded["loss"],
                                   rtol=1e-4)
        assert int(o["metrics"]["num_points"]) == int(sharded["num_points"])
        # (JAX's CPU encode counts no residual corners: encode_resid is
        # not compared)
        assert int(o["metrics"]["pool_overflow"]) == int(
            sharded["pool_overflow"])
    np.testing.assert_allclose(np.mean(ref["losses"]), sharded["loss"],
                               rtol=1e-6)
    got = outs[0]["grads"]
    for name, want in ref["mean_grad"].items():
        want, g = want.numpy(), got[name].numpy()
        scale = float(np.abs(want).max())
        if name.startswith("specular_net"):     # diffuse warmup: no gradient
            assert scale == 0 and not g.any(), name
            continue
        # test_torch_slice.py's tolerances (the table's near-zero corner
        # weights carry ulp-level position differences)
        atol = (1e-4 if name == "table" else 1e-6) * scale
        np.testing.assert_allclose(g, want, rtol=1e-3, atol=atol,
                                   err_msg=name)
        assert np.linalg.norm(g - want) <= 1e-4 * np.linalg.norm(want), name


def test_stage0_ranks_stay_bit_equal(ranks):
    a, b = (o["after"] for o in ranks["outs"])
    assert a == b
    assert a["step"] == 20 and a["iter_density"] == 8 + 1
    assert a["num_rays"] != N_RAYS               # the probe ran, reduced
    s0, s1 = (o["seeds"] for o in ranks["outs"])
    assert s0[0] == 0 and s0[0] != s1[0] and s0[1] == s1[1]


def test_stage1_step_mean_face_errors_and_refine(ranks):
    outs, root = ranks["outs"], ranks["root"]
    ws = os.path.join(ranks["workdir"], "ws")
    # the ranks' field, offsets and mesh before the step; ckpt "scratch"
    # loads mesh_0.ply, as the ranks did before their refine wrote
    # mesh_0_updated.ply
    t = Trainer(stage1_cfg(tiny(TConfig, root, ckpt="scratch")),
                device="cpu", workspace=ws)
    ds = load_nerf_dataset(t.cfg, "train")
    t.setup_stage1(ds)
    with torch.no_grad():
        for k, p in t._named_params().items():
            p.copy_(outs[0]["s1_params0"][k])
            assert torch.equal(outs[1]["s1_params0"][k], p), k
    images, poses, intr = t._prep_train_arrays(ds)
    mvps = torch.from_numpy(ds.mvps)
    assert outs[0]["s1_draws"]["img"] != outs[1]["s1_draws"]["img"] or \
        outs[0]["s1_draws"]["origin"] != outs[1]["s1_draws"]["origin"]
    grads = []
    for o in outs:
        t.optimizer.zero_grad(set_to_none=True)
        loss, _, _, _ = t._stage1_crop_loss(images, poses, mvps, intr,
                                            o["s1_draws"])
        loss.backward()
        grads.append({k: (torch.zeros_like(p) if p.grad is None
                          else p.grad.clone())
                      for k, p in t._named_params().items()})
    for k in grads[0]:
        mean = (grads[0][k] + grads[1][k]) / 2
        for o in outs:
            np.testing.assert_allclose(o["s1_grads"][k].numpy(), mean.numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
    # the refine sums the errors, then the counts, over the ranks
    assert len(outs[0]["s1_reduced"]) == len(outs[1]["s1_reduced"]) == 2
    for (b0, a0), (b1, a1) in zip(outs[0]["s1_reduced"],
                                  outs[1]["s1_reduced"]):
        assert b0.sum() > 0 and b1.sum() > 0 and not torch.equal(b0, b1)
        torch.testing.assert_close(a0, b0 + b1, rtol=0, atol=0)
        torch.testing.assert_close(a1, b0 + b1, rtol=0, atol=0)
    a, b = (o["s1_after"] for o in outs)
    assert a["step"] == S1_STEPS and a["refines"] == b["refines"]
    assert len(a["refines"]) == 1 and a["refines"][0][0] == S1_REFINE
    assert a["faces0"] != len(a["triangles"]) or \
        a["refines"][0][1] != a["refines"][0][2]
    np.testing.assert_array_equal(a["vertices"], b["vertices"])
    np.testing.assert_array_equal(a["triangles"], b["triangles"])
    assert a["digest"] == b["digest"]
    names = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    assert names == [f"ngp_stage1_{S1_STEPS:07d}.ckpt",
                     "ngp_stage1_latest.ckpt"], names


def test_cli_under_two_ranks_writes_once(ranks):
    a, b = (o["cli"] for o in ranks["outs"])
    assert a["step0"] == b["step0"] == 16 and a["step1"] == b["step1"] == 4
    assert a["refines"] == b["refines"] and a["refines"][0][0] == 2
    for msg in (a["mismatch"], b["mismatch"]):
        assert "--mesh_shape 3" in msg and "started 2 ranks" in msg
    ws = os.path.join(ranks["workdir"], "cli")
    assert sorted(os.listdir(os.path.join(ws, "checkpoints"))) == [
        "ngp_stage0_0000016.ckpt", "ngp_stage0_best.ckpt",
        "ngp_stage0_latest.ckpt", "ngp_stage1_0000004.ckpt",
        "ngp_stage1_best.ckpt", "ngp_stage1_latest.ckpt"]
    assert sorted(os.listdir(os.path.join(ws, "mesh_stage0"))) == [
        "mesh_0.ply", "mesh_0_updated.ply"]
    assert sorted(os.listdir(os.path.join(ws, "mesh_stage1"))) == [
        "feat0_0.jpg", "feat1_0.jpg", "mesh_0.mtl", "mesh_0.obj",
        "mlp.json"]
    leftovers = [f for d, _, fs in os.walk(ws) for f in fs
                 if f.endswith(".tmp")]
    assert not leftovers, leftovers


def test_one_rank_group_is_the_single_device_trainer(tmp_path):
    from nerf2mesh_tpu_torch.data.provider import dataset_from_frames
    from nerf2mesh_tpu_torch.data.synthetic import render_synthetic_frames
    from nerf2mesh_tpu_torch.parallel import distributed
    cfg = tiny(TConfig, stochastic_fine=True)
    ds = dataset_from_frames(cfg, render_synthetic_frames(**SCENE))

    def run():
        t = Trainer(cfg, device="cpu", workspace=str(tmp_path))
        t.mark_untrained(ds)
        t.train_steps(ds, 18)
        return t.world, t.num_rays, distributed.digest(
            list(t.params.parameters()) + [t.render.density_grid])

    torch.set_num_threads(1)
    alone = run()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                            rank=0, world_size=1)
    try:
        grouped = run()
    finally:
        dist.destroy_process_group()
    assert alone == grouped and alone[0] == 1


def test_backend_rule(monkeypatch):
    from nerf2mesh_tpu_torch.parallel.distributed import choose_backend
    assert choose_backend("cpu", 1, 2) == ("gloo", torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    # a card for every local rank: NCCL, rank r on cuda:r
    assert choose_backend(None, 3, 4) == ("nccl", torch.device("cuda", 3))
    # more local ranks than cards: gloo, the ranks share the cards
    assert choose_backend("cuda", 5, 8) == ("gloo", torch.device("cuda", 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        choose_backend(None, 0, 2)
